from .expr import Expr, col, lit, len_ as len  # noqa
