from .python_fe import compile_python, Either, Left, Right, secret, public, u32

__all__ = ["compile_python", "Either", "Left", "Right", "secret", "public", "u32"]
