from .camera import (
    camera_geometry,
    camera_rays,
    camera_rays_components,
    pixel_dirs_body,
    tile_cones_body,
)
from .sphere_trace import (
    Lighting,
    bake_lighting,
    cone_warm_start,
    lambert_shade,
    render_camera,
    render_sensors,
    trace_cones_grouped,
)
from .trace_kernel import (
    KernelScene,
    kernel_scene_sdf,
    prepare_kernel_scene,
    trace_analytic,
    trace_analytic_reference,
    trace_diff,
    trace_march,
    trace_march_reference,
)

__all__ = [
    "pixel_dirs_body",
    "tile_cones_body",
    "camera_geometry",
    "camera_rays",
    "camera_rays_components",
    "Lighting",
    "bake_lighting",
    "cone_warm_start",
    "lambert_shade",
    "render_camera",
    "render_sensors",
    "trace_cones_grouped",
    "KernelScene",
    "kernel_scene_sdf",
    "prepare_kernel_scene",
    "trace_analytic",
    "trace_analytic_reference",
    "trace_march",
    "trace_march_reference",
    "trace_diff",
]
