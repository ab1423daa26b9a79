from .ops import cycle_draw, cycle_move, cycle_route  # noqa: F401
