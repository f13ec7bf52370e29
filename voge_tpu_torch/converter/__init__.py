"""Scene converters, shapes and IO (counterpart of ``voge_tpu.converter``):
the cuboid generator, the icosphere / OBJ shapes, the mesh and pointcloud
converters, and the OFF / COFF / GOFF files."""
from voge_tpu_torch.converter import cuboid as Cuboid
from voge_tpu_torch.converter import converters, io, shapes
from voge_tpu_torch.converter import converters as Converters
from voge_tpu_torch.converter import io as IO
from voge_tpu_torch.converter.converters import (
    ComposedConverter,
    convert_path,
    fixed_pointcloud_converter,
    get_vert_edge_length,
    naive_point_cloud_converter,
    naive_vertices_converter,
    normal_mesh_converter,
    pytorch3d2gaussian,
    to_gaussian_mesh,
)
from voge_tpu_torch.converter.cuboid import cuboid_gauss
from voge_tpu_torch.converter.io import load_goff, load_off, save_goff, save_off
from voge_tpu_torch.converter.shapes import ico_sphere, load_obj, vertex_normals

__all__ = ["ComposedConverter", "Converters", "Cuboid", "IO", "convert_path", "converters",
           "cuboid_gauss", "fixed_pointcloud_converter", "get_vert_edge_length",
           "ico_sphere", "io", "load_goff", "load_obj", "load_off",
           "naive_point_cloud_converter", "naive_vertices_converter",
           "normal_mesh_converter", "pytorch3d2gaussian", "save_goff", "save_off",
           "shapes", "to_gaussian_mesh", "vertex_normals"]
