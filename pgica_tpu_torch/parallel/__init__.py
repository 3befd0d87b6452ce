"""Data parallelism on ``torch.distributed``: the device mesh, its collectives, ZeRO-1 and ZeRO-3."""
