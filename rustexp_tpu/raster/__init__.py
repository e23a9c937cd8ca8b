"""Software rasterizer: camera paths, shader library, render pipeline.

Array-native redesign of the reference's Rust rasterizer (rs-src/rasterizer.rs):
vertex transforms are batched array ops, rasterization is a per-tile queue
kernel producing z and interpolated attribute planes, and all 16 shaders run as one
deferred, vectorized pass over the frame — each visible pixel is shaded
exactly once, instead of per overdrawn fragment as in the reference.
"""
