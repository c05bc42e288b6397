"""Host-side data layer of the port: datasets, batching loader, split files
(copies of sv3d_tpu/data)."""
