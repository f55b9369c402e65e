"""Core abstractions of the port: device places, the Program IR
(``framework``), scope, op registry, interpreter and shape inference."""

from ..reader.py_reader import EOFException  # noqa: F401  (fluid.core.EOFException)
