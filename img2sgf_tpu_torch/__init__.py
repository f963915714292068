"""img2sgf_tpu_torch: the PyTorch and CUDA port of img2sgf_tpu.

Converts images of printed Go diagrams into SGF files with the same
detection semantics as the JAX package, which stays the reference. Plain
tensor code is PyTorch; the three Pallas kernels of the JAX package are
hand-written CUDA kernels for Hopper (sm_90a) in csrc/, built with nvcc at
first use. On a card the jitted entry points of the JAX package
(detect_board_jit, detect_board_auto, detect_board_batch,
detect_board_bucket_batch) replay CUDA graphs captured at their first call
(pipeline/graphs.py). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead, and every entry point runs eagerly.
"""

from .config import DetectionConfig, choose_line_threshold, from_jax_config
from .core import BLACK, WHITE, Alignment, BoardStates, guess_side_to_move, to_sgf
from .pipeline import (
    BoardResult,
    bucket_dim,
    detect_board,
    detect_board_auto,
    detect_board_batch,
    detect_board_bucket_batch,
    detect_board_jit,
)

__version__ = "0.1.0"

__all__ = [
    "DetectionConfig",
    "choose_line_threshold",
    "from_jax_config",
    "BLACK",
    "WHITE",
    "Alignment",
    "BoardStates",
    "guess_side_to_move",
    "to_sgf",
    "BoardResult",
    "bucket_dim",
    "detect_board",
    "detect_board_auto",
    "detect_board_batch",
    "detect_board_bucket_batch",
    "detect_board_jit",
]
