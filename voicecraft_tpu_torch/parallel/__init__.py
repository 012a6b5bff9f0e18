"""Device meshes: lane-sharded and tensor-parallel serving, dp x tp
training with ZeRO-1 (parallel/mesh.py)."""
