"""simple_pbft_tpu_torch — the PyTorch / CUDA port of simple_pbft_tpu.

The consensus plane (replica, state machine, view change, transport,
client) is framework-free Python, carried over as the port's own copy.
The crypto plane's device side — GF(2^255 - 19) limb arithmetic and the
fused comb-table Ed25519 verifier — is PyTorch on a CUDA device, with the
64-position mixed-add accumulation as a hand-written CUDA kernel
(``csrc/fused_accumulate.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; when
no CUDA device is present they raise instead of falling back.

Native code (the CUDA kernel and the copied C++ host helpers) builds at
first use from the package's sources into ``BUILD_DIR``, which git
ignores.
"""

from __future__ import annotations

import os

__version__ = "0.1.0"

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_dir() -> str:
    """Create (if needed) and return the package's build directory."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def resolve_device(device="cuda"):
    """`device` as a torch.device; raises RuntimeError when it names CUDA
    and no CUDA device is present, so no result is ever a silent CPU
    number. A CPU run must ask for ``device="cpu"`` itself."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def default_device():
    """The CUDA device entry points use when the caller names none."""
    return resolve_device("cuda")
