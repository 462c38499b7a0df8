from .loader import (TrackMap, load_map_yaml, load_builtin, build_track_map,
                     read_pgm, occupancy_from_image, sample_free_poses)
from .edt import edt, edt_numpy
from .sectors import SectorSegmentMap, build_sector_map
from .segments import SegmentMap, build_segment_map
