"""Sharded and multi-process paths of the port: the shard group that stands
in for the JAX package's device mesh (``group.py``), the multi-process
bootstrap (``multihost.py``), the sharded count table (``sharded_sorted.py``)
and the shard-resident incidence (``sharded_inc.py``)."""
