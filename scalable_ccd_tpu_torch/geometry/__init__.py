"""Geometry: conservative boxes, mesh IO and procedural scenes."""

from scalable_ccd_tpu_torch.geometry.aabb import (
    AABBs,
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.geometry.mesh import (
    edges_from_faces,
    read_ply,
    validate_mesh_inputs,
    write_ply,
)

__all__ = [
    "AABBs",
    "build_vertex_boxes",
    "build_edge_boxes",
    "build_face_boxes",
    "edges_from_faces",
    "read_ply",
    "write_ply",
    "validate_mesh_inputs",
]
