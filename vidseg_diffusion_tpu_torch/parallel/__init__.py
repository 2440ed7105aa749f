"""More than one process over torch.distributed: the process group and the
sweep's split (mesh.py), the (mask, +/-lambda) runs over ranks (runs.py) and
FSDP training (fsdp.py)."""
