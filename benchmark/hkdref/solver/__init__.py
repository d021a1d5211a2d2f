"""Sub-package of the frozen plain reference; see the package docstring."""
