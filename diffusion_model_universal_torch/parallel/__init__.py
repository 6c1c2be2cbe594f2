"""Parallelism of the port (counterpart of the reference's ``parallel/``):
data parallelism over ``torch.distributed`` (:mod:`.mesh`)."""
