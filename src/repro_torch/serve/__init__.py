from repro_torch.serve.engine import make_decode_step, make_prefill_step
