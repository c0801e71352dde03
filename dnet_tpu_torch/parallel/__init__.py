"""Mesh serving: the mesh spec, the pipeline stages, the sp ranks and MeshEngine."""
