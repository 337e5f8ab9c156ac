"""Partitions of a mesh's cells (the port's copy of the JAX package's
``firedrake_tpu/parallel/partition.py``, so far the space-filling-curve
order alone, which BDDC's subdomains are cut from)."""
