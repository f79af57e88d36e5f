"""Serving I/O (own copy of the part of ``repro.gateway`` the serve loop
uses: ``io.LineSource``).  The multi-tenant gateway comes with a later
slice of the port."""
from .io import LineSource

__all__ = ["LineSource"]
