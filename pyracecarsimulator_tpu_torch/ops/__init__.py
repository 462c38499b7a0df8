from .common import beam_angles, quantize_angles, rays_from_poses
from .raycast_sectors import scan_poses_sectors, sector_sweep, sweep_plain
from .noise import add_scan_noise
