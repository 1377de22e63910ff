"""Model parallelism in one process per host: tensor (tp), expert (ep),
sequence (sp), pipeline (pp) and data (dp) meshes, for serving and for
training, and the multi-host backend.

Reference: ``agentainer_tpu/parallel/`` — ``mesh``, ``sharding``,
``flash_mesh``, ``expert``, ``pipeline``, ``ring_attention``, ``ulysses``
and ``dcn``; ``collectives`` is new (GSPMD inserts the reference's
collectives). The reference is single-controller: one process holds a
``Mesh`` over the agent's chips and GSPMD or ``shard_map`` place the work.
The port keeps that: a mesh is a list of shards, each holding its slice of
the weights (and, serving, of the KV arena) as its own tensors on its own
device, and the shards meet only in the explicit collectives of
``collectives.py``. The same code runs with every shard on the CPU (the
tests' counterpart of the reference's virtual 8-device mesh), with several
shards on one card (a logical mesh), and with shards on several cards
(peer copies). Only a mesh across hosts (``dcn.host_mesh``) has a process
per host: dp spans them, and its sums go through ``torch.distributed``.

``compat.py`` has no counterpart: it is the reference's JAX-version seam
for ``shard_map``.
"""
