"""Mesh encoding, segmentation, preconditioning, the consumer scheduler,
block storage and the relation engine."""
