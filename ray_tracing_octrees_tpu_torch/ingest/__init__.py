from ray_tracing_octrees_tpu_torch.ingest.csv_loader import (
    assemble_triangles,
    load_csv_faces,
    load_csv_vertices,
)
from ray_tracing_octrees_tpu_torch.ingest.voxelize import (
    load_csv_into_voxel_grid,
    point_in_triangle,
    voxelize_triangles,
    voxelize_triangles_dense,
)

__all__ = [
    "load_csv_vertices",
    "load_csv_faces",
    "assemble_triangles",
    "voxelize_triangles",
    "voxelize_triangles_dense",
    "load_csv_into_voxel_grid",
    "point_in_triangle",
]
