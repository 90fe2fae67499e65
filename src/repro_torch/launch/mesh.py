"""DEPRECATED re-export shim: mesh construction lives in
:mod:`repro_torch.topology.mesh`.  Import from :mod:`repro_torch.topology`;
importing this module warns."""
import warnings

from repro_torch.topology.mesh import (  # noqa: F401
    axis_size,
    data_axes,
    make_host_mesh,
    make_production_mesh,
    make_serve_mesh,
)

warnings.warn(
    "repro_torch.launch.mesh is a deprecated shim; import from "
    "repro_torch.topology", DeprecationWarning, stacklevel=2)

__all__ = ["axis_size", "data_axes", "make_host_mesh",
           "make_production_mesh", "make_serve_mesh"]
