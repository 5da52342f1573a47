"""Hand-written Pallas kernels, on the Triton route (backend="triton").

fieldgen: the coordinate-MLP field generator as a forward/backward pair
that recomputes the hidden activation instead of storing it.
"""
