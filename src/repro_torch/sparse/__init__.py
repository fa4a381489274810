"""Host-side sparse containers and the Table-I matrix generators."""
