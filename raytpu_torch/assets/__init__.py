"""The OBJ assets of raytpu_torch: copies of raytpu's, byte for byte, and
``make_assets``, which writes the procedural ones."""
