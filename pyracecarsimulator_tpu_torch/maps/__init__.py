from .loader import (TrackMap, load_map_yaml, load_builtin, build_track_map,
                     add_obstacle, clear_obstacles, read_pgm,
                     occupancy_from_image, sample_free_poses)
from .edt import edt, edt_numpy
from .sectors import (SectorSegmentMap, StackedSectorMap, add_segments,
                      build_sector_map, stack_sector_maps)
from .segments import SegmentMap, build_segment_map
from .contours import GeneralSegmentMap, build_general_segment_map
