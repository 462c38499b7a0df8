from .common import beam_angles, quantize_angles, rays_from_poses
from .raycast_segments import raycast_all, raycast_tiled, scan_poses_segments
from .raycast_grad import raycast_all_diff, raycast_tiled_diff
# (raycast_pallas itself is not re-exported: the name would shadow its
# module, as it does in the JAX package)
from .raycast_pallas import scan_poses_pallas
from .raycast_sectors import scan_poses_sectors, sector_sweep, sweep_plain
from .noise import add_scan_noise
