"""Distributed training (port of ``repro.distributed``).

Ported so far: ``compress`` (int8 gradient compression with error
feedback). The reference's package exports the sharding rules of its
device mesh, which are not ported yet, so this one exports nothing.
"""
