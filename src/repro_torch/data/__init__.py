"""Synthetic tetrahedral meshes."""
