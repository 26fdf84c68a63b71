"""Tools of the PyTorch/CUDA port that run on a CUDA card."""
