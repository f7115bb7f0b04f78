from .roiaware_pool3d_utils import (in_box_frame, points_in_boxes,  # noqa: F401
                                    pool_cells, roiaware_cells,
                                    roiaware_pool3d)
