"""Device numerics of the port: GF(2^255-19) limb arithmetic
(``field25519``) and the fused comb-table double-scalar multiplication
(``comb``), as int32 PyTorch tensor code with one hand-written CUDA
kernel for the mixed-add accumulation."""
