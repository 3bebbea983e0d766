"""Camera geometry, warps and depth regression; the names atvsnet_tpu/geometry exports."""

from atvsnet_torch.geometry.cameras import depth_range_from_cams, split_cam  # noqa: F401
from atvsnet_torch.geometry.depth_regression import (  # noqa: F401
    prob2depth,
    prob2depth_upsample,
    probability_map,
    upsample_prob_vol,
)
from atvsnet_torch.geometry.homography import get_homographies, pixel_grid  # noqa: F401
from atvsnet_torch.geometry.visual_hull import get_visual_hull  # noqa: F401
from atvsnet_torch.geometry.warp import (  # noqa: F401
    homography_warp,
    interpolate,
    plane_sweep_warp,
    transform_depth,
    warp_by_depth,
)
