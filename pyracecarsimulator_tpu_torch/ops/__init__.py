from .common import beam_angles, quantize_angles, rays_from_poses
from .raycast_segments import raycast_all, raycast_tiled, scan_poses_segments
from .raycast_grad import raycast_all_diff, raycast_tiled_diff
# (raycast_pallas, raycast_general and soft_edt themselves are not
# re-exported: each name would shadow its module, as in the JAX package)
from .raycast_pallas import scan_poses_pallas
from .raycast_sectors import scan_poses_sectors, scan_poses_sectors_multi
from .raymarch_xla import march_rays, scan_poses
from .raycast_general import raycast_general_tiled, scan_poses_general
from .soft_edt import scan_from_occupancy
from .noise import add_scan_noise
