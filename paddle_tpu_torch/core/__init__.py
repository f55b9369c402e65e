"""Core abstractions of the port: device places, the Program IR
(``framework``), scope, op registry, interpreter and shape inference."""
