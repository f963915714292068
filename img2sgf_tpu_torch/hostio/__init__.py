from .image import crop_and_rotate, load_rgb, screen_capture

__all__ = ["crop_and_rotate", "load_rgb", "screen_capture"]
