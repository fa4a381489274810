from repro_torch.data.pipeline import SyntheticLM, batch_for_cell
