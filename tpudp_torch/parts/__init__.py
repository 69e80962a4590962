"""The four Part trainers of the reference, on the port: ``python -m
tpudp_torch.parts.part1`` (no sync), ``part2a`` (coordinator), ``part2b``
(all-reduce; ``--ring``, ``--bf16-grads`` or ``--int8-grads``) and
``part3`` (DistributedDataParallel)."""
