"""Ray-axis data parallelism over ``torch.distributed`` (``sharding.py``)."""
