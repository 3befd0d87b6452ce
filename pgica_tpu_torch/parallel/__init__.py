"""Parallelism on ``torch.distributed``: the device mesh, its collectives, ZeRO-1 and ZeRO-3, the partition
rules, tensor parallelism and FSDP at rest."""
