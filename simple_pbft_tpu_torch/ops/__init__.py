"""Device numerics of the port: GF(2^255-19) limb arithmetic
(``field25519``), Edwards25519 points (``edwards``), the fused and comb
double-scalar multiplications with their hand-written CUDA kernels
(``comb``), and the ladder mode's keyless verify with its kernel
(``ladder``), as int32 PyTorch tensor code."""
