"""Exchange-correlation functionals and grid quadrature."""

from .functionals import FUNCTIONALS, resolve_functional
from .xc import make_xc_fn

__all__ = ["FUNCTIONALS", "resolve_functional", "make_xc_fn"]
