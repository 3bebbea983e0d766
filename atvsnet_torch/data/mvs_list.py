"""pair.txt cluster lists (MVSNet format), reference preprocess.py:228-260 (the port's
copy of atvsnet_tpu/data/mvs_list.py)."""

from __future__ import annotations

import os
from typing import List


def gen_pipeline_mvs_list(dense_folder: str, view_num: int) -> List[List[str]]:
    """Parse pair.txt: [n_refs, (ref_idx, n_views, (view_idx, score)*)*].

    Returns one [ref_img, ref_cam, view_img, view_cam, ...] path list per ref image.
    """
    image_folder = os.path.join(dense_folder, "images")
    cam_folder = os.path.join(dense_folder, "cams")
    with open(os.path.join(dense_folder, "pair.txt")) as f:
        cluster_list = f.read().split()

    mvs_list = []
    pos = 1
    for _ in range(int(cluster_list[0])):
        paths = []
        ref_index = int(cluster_list[pos])
        pos += 1
        paths.append(os.path.join(image_folder, f"{ref_index:08d}.jpg"))
        paths.append(os.path.join(cam_folder, f"{ref_index:08d}_cam.txt"))
        all_view_num = int(cluster_list[pos])
        pos += 1
        check_view_num = min(view_num - 1, all_view_num)
        for view in range(check_view_num):
            view_index = int(cluster_list[pos + 2 * view])
            paths.append(os.path.join(image_folder, f"{view_index:08d}.jpg"))
            paths.append(os.path.join(cam_folder, f"{view_index:08d}_cam.txt"))
        pos += 2 * all_view_num
        mvs_list.append(paths)
    return mvs_list
