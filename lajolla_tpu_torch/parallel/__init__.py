"""Multi-GPU rendering on torch.distributed (mesh.py), and a helper that
starts the ranks of a function on one machine (spawn.py)."""
