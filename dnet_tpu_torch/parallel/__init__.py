"""Sequence-parallel serving: the mesh spec, the sp ranks and MeshEngine."""
