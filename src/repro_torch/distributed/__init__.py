"""The sharded PIR path's shard-local building blocks (`collectives`),
driven from one process over a `repro_torch.launch.mesh.DeviceMesh`.

The JAX package's LM-side collectives (sharded embedding lookup, split-S
decode attention, the ring all-reduce) and ``sharding.py``'s rules are not
ported yet: they come with the model and training slices.
"""
