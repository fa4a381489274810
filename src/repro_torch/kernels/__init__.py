"""Hand-written CUDA kernels for the SpTRSV hot loop, their plain PyTorch
versions, and the dispatch between them."""
