"""Command-line entry points: ``python -m repro_torch.launch.solve`` (one
matrix, one solve mode, timed and checked against scipy) and
``python -m repro_torch.launch.serve_solve`` (a multi-tenant request mix
through the solve service and the plan store)."""
