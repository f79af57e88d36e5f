"""Roofline of the port's cells on an H100: per-rank costs counted on
meta tensors (``cost``), the three-term roofline (``analysis``), the
per-op breakdown (``breakdown``) and the report tables (``report``)."""
