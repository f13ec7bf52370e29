"""Scene converters and shapes (counterpart of ``voge_tpu.converter``): the
cuboid generator, the icosphere / OBJ shapes and the mesh-vertex
converter.  The other converters and the IO wait for a later slice."""
from voge_tpu_torch.converter import cuboid as Cuboid
from voge_tpu_torch.converter import converters, shapes
from voge_tpu_torch.converter.converters import (
    get_vert_edge_length,
    naive_vertices_converter,
)
from voge_tpu_torch.converter.cuboid import cuboid_gauss
from voge_tpu_torch.converter.shapes import ico_sphere, load_obj, vertex_normals

__all__ = ["Cuboid", "converters", "cuboid_gauss", "get_vert_edge_length",
           "ico_sphere", "load_obj", "naive_vertices_converter", "shapes",
           "vertex_normals"]
