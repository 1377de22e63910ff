"""Serve-time model parallelism: tensor (tp), expert (ep), sequence (sp)
and pipeline (pp) meshes in one engine process.

Reference: ``agentainer_tpu/parallel/`` — ``mesh``, ``sharding``,
``flash_mesh``, ``expert`` and the serve half of ``pipeline``;
``collectives`` is new (GSPMD inserts the reference's collectives). The
reference is single-controller: one process holds a ``Mesh`` over the
agent's chips and GSPMD or ``shard_map`` place the work. The port keeps that: a mesh is a list of shards, each holding its
slice of the weights and of the KV arena as its own tensors on its own
device, and the shards meet only in the explicit collectives of
``collectives.py``. The same code runs with every shard on the CPU (the
tests' counterpart of the reference's virtual 8-device mesh), with several
shards on one card (a logical mesh), and with shards on several cards
(peer copies).

``compat.py`` has no counterpart: it is the reference's JAX-version seam
for ``shard_map``. Training over a mesh (``ring_attention``, ``ulysses``,
the training half of ``pipeline``) and the multi-host ``dcn`` wait for
later slices.
"""
