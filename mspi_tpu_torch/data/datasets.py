"""Dataset split lists: counterpart of `read_fold_list` in
`mspi_tpu/data/datasets.py`.

Layout: <root>/fold_lists/{DS}_list_{mode}[_{split}]_fps.txt with lines
"name frame_num fps" (DIEM has no split number).
"""

from __future__ import annotations

import os


def fold_list_name(dataset_name: str, mode: str, split: int) -> str:
    if dataset_name == "DIEM":
        return f"DIEM_list_{mode}_fps.txt"
    return f"{dataset_name}_list_{mode}_{split}_fps.txt"


def read_fold_list(path_data: str, dataset_name: str, mode: str, split: int):
    """Returns (sorted names, {name: fps}, {name: frame_num})."""
    names, fps, frame_num = [], {}, {}
    path = os.path.join(path_data, "fold_lists", fold_list_name(dataset_name, mode, split))
    with open(path) as f:
        for line in f.readlines():
            name, n, v = line.split(" ")
            names.append(name)
            frame_num[name] = int(n)
            fps[name] = float(v)
    names.sort()
    return names, fps, frame_num
