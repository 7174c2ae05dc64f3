from .generator import (
    LANE_OFFSETS, MAX_TRACK_PTS, PLAYFIELD, TRACK_WIDTH, Track,
    lane_points, make_track, tile_quads,
)
from .geometry import (
    SegmentQuery, TrackGeometry, build, from_arrays,
    nearest_segment, on_road, sample_texture, stack,
)
from .texture import BASE_PALETTE, LANE_PALETTE, bake_texture

__all__ = [
    "Track", "make_track", "lane_points", "tile_quads", "TrackGeometry",
    "build", "stack", "from_arrays", "SegmentQuery",
    "nearest_segment", "on_road", "sample_texture", "bake_texture",
    "BASE_PALETTE", "LANE_PALETTE", "MAX_TRACK_PTS", "PLAYFIELD",
    "TRACK_WIDTH", "LANE_OFFSETS",
]
