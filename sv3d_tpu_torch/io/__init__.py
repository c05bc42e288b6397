"""Host file formats of the port: EXR, RGB images, OBJ meshes, .df volumes
(copies of the parts of sv3d_tpu/io that the port uses)."""
