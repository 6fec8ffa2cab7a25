"""The relation-block producer: the plain torch arm (``ops``) and the
hand-written CUDA kernels (``segment_relations``, sources in ``csrc/``)."""
