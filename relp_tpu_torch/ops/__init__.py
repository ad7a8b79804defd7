"""Device operators: the constraint-matrix layouts, the hand-written CUDA
kernels behind the sparse layout, and basis-inverse linear algebra."""
