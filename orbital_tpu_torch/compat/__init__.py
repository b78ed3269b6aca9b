"""Compatibility layouts over the port. ``compat/core`` serves the reference's
``core.*`` import layout (``trevormcguire/orbital-physics``) from
``orbital_tpu_torch``: put this directory on ``sys.path`` ahead of any other
``core`` package and reference user code imports ``core.*`` unchanged."""
