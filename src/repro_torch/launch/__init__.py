"""Command-line entry points: ``python -m repro_torch.launch.solve`` (one
matrix, one solve mode, timed and checked against scipy),
``python -m repro_torch.launch.serve_solve`` (a multi-tenant request mix
through the solve service and the plan store), and for the LM substrate
``python -m repro_torch.launch.serve`` (prefill and greedy decode) and
``python -m repro_torch.launch.train`` (the training loop with
checkpoints and resume); ``mesh`` and ``specs`` build the production
meshes and every shape cell's inputs as meta DTensors."""
