"""The port's benchmark: cells of a model configuration under a traffic mix,
driven through ``agentainer_tpu_torch``'s engine in process (``run.py``)."""
