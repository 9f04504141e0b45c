"""Device plane of the port: traversal over bitmaps and its kernels."""
