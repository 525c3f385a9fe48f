"""Mesh construction for the port (counterpart of the reference's
``launch/``): a mesh of virtual ranks on one device, or the same mesh
spread over processes (launch/procs.py)."""
from .mesh import (Mesh, launch_mesh, make_host_mesh, make_hybrid_mesh,
                   make_mesh, make_production_mesh, process_mesh)

__all__ = ["Mesh", "launch_mesh", "make_host_mesh", "make_hybrid_mesh",
           "make_mesh", "make_production_mesh", "process_mesh"]
