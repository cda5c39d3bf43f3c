from .camera import camera_geometry, camera_rays_components, pixel_dirs_body
from .sphere_trace import render_camera, render_sensors
from .trace_kernel import (
    KernelScene,
    prepare_kernel_scene,
    trace_analytic,
    trace_analytic_reference,
)

__all__ = [
    "pixel_dirs_body",
    "camera_geometry",
    "camera_rays_components",
    "render_camera",
    "render_sensors",
    "KernelScene",
    "prepare_kernel_scene",
    "trace_analytic",
    "trace_analytic_reference",
]
