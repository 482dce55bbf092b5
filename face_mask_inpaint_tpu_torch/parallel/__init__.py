"""Data parallel over ``torch.distributed`` (see ``parallel/dist.py``)."""
