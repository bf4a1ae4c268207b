"""Task package: importing it fires every @register_algorithm decorator."""

from ..serve import serve  # noqa: F401 -- registers the `serve` task
