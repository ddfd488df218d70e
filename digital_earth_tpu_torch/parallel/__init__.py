"""Multi-device rendering over an (n_px, n_spp) device mesh (parallel/mesh.py)."""
