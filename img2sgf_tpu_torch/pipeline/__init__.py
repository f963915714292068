from .detect import (
    BoardResult,
    bucket_dim,
    detect_board,
    detect_board_auto,
    detect_board_batch,
    detect_board_bucket_batch,
    detect_board_jit,
)

__all__ = ["BoardResult", "bucket_dim", "detect_board", "detect_board_auto",
           "detect_board_batch", "detect_board_bucket_batch",
           "detect_board_jit"]
