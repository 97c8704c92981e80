"""LiveLink-format CSV export and offline CSV utilities (the port's own
copy of neurosync_trainer_lite_tpu/utils/csv_io.py, with the csv module and
numpy, so no pandas is needed).

save_generated_data_as_csv writes the JAX package's file byte for byte
(pandas' to_csv): Timecode (HH:mm:ss:ff.mmm at 60 fps), BlendshapeCount and
the 61 named ARKit blendshape columns, plus 7 optional emotion columns.
"""

from __future__ import annotations

import csv

import numpy as np

BASE_COLUMNS = [
    "Timecode", "BlendshapeCount",
    "EyeBlinkLeft", "EyeLookDownLeft", "EyeLookInLeft", "EyeLookOutLeft",
    "EyeLookUpLeft", "EyeSquintLeft", "EyeWideLeft", "EyeBlinkRight",
    "EyeLookDownRight", "EyeLookInRight", "EyeLookOutRight", "EyeLookUpRight",
    "EyeSquintRight", "EyeWideRight", "JawForward", "JawRight", "JawLeft",
    "JawOpen", "MouthClose", "MouthFunnel", "MouthPucker", "MouthRight",
    "MouthLeft", "MouthSmileLeft", "MouthSmileRight", "MouthFrownLeft",
    "MouthFrownRight", "MouthDimpleLeft", "MouthDimpleRight",
    "MouthStretchLeft", "MouthStretchRight", "MouthRollLower",
    "MouthRollUpper", "MouthShrugLower", "MouthShrugUpper", "MouthPressLeft",
    "MouthPressRight", "MouthLowerDownLeft", "MouthLowerDownRight",
    "MouthUpperUpLeft", "MouthUpperUpRight", "BrowDownLeft", "BrowDownRight",
    "BrowInnerUp", "BrowOuterUpLeft", "BrowOuterUpRight", "CheekPuff",
    "CheekSquintLeft", "CheekSquintRight", "NoseSneerLeft", "NoseSneerRight",
    "TongueOut", "HeadYaw", "HeadPitch", "HeadRoll", "LeftEyeYaw",
    "LeftEyePitch", "LeftEyeRoll", "RightEyeYaw", "RightEyePitch",
    "RightEyeRoll",
]

EMOTION_COLUMNS = ["Angry", "Disgusted", "Fearful", "Happy", "Neutral",
                   "Sad", "Surprised"]

DIMENSION_LABELS = BASE_COLUMNS[2:]  # the 61 blendshape names in order


def make_timecode(i: int, frame_rate: int = 60) -> str:
    """Frame index → 'HH:mm:ss:ff.mmm'."""
    total_seconds = i / frame_rate
    hours, remainder = divmod(total_seconds, 3600)
    minutes, seconds = divmod(remainder, 60)
    milliseconds = (seconds - int(seconds)) * 1000
    frame_number = int(milliseconds / (1000 / frame_rate))
    return (f"{int(hours):02}:{int(minutes):02}:{int(seconds):02}:"
            f"{frame_number:02}.{int(milliseconds):03}")


def save_generated_data_as_csv(generated, output_path: str,
                               include_emotion_dimensions: bool = False) -> None:
    """[T, 61|68] blendshape array → LiveLink CSV."""
    generated = np.array(generated)
    if generated.ndim != 2 or generated.shape[1] not in (68, 61):
        raise ValueError(
            f"Expected generated data to have 68 or 61 columns, got shape "
            f"{generated.shape}")
    if include_emotion_dimensions:
        columns, data = BASE_COLUMNS + EMOTION_COLUMNS, generated
    else:
        columns, data = BASE_COLUMNS, generated[:, :61]
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for i, row in enumerate(data):
            # numpy's shortest repr of each value in its own dtype, as
            # pandas writes it (a float32 value is not widened first)
            writer.writerow([make_timecode(i), data.shape[1],
                             *map(str, row)])
    print(f"Generated data saved to {output_path}")


def read_csv_rows(path: str) -> tuple[list[str], list[list[str]]]:
    """A CSV file → (header, rows of cell strings)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [row for row in reader if row]


def read_columns(path: str, start: int, stop: int) -> np.ndarray:
    """Columns [start, stop) of a CSV (by position, as pandas' iloc; fewer
    where the file has fewer) as float64 [rows, columns]."""
    header, _ = read_csv_rows(path)
    cols = list(range(start, min(stop, len(header))))
    return np.loadtxt(path, delimiter=",", skiprows=1, usecols=cols,
                      dtype=np.float64, ndmin=2)


def pad_data(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the shorter of two [rows, ...] arrays to the longer's row
    count (reference: plot_comparison.py:5-15)."""
    n = max(len(a), len(b))

    def pad(x):
        if len(x) == n:
            return x
        return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:],
                                           dtype=x.dtype)])

    return pad(a), pad(b)


def plot_comparison(ground_truth_path: str, generated_path: str,
                    output_image_path: str,
                    features_to_plot=("JawOpen",)) -> None:
    """Overlay plot of ground truth vs generated, first 512 frames
    (reference: plot_comparison.py:17-45). Skipped, with one warning for the
    process, where matplotlib is not installed."""
    from neurosync_trainer_lite_tpu_torch.utils.plots import pyplot

    plt = pyplot()
    if plt is None:
        return
    gt_header, gt_rows = read_csv_rows(ground_truth_path)
    gen_header, gen_rows = read_csv_rows(generated_path)

    def column(header, rows, name, kind=float):
        return np.array([kind(row[header.index(name)]) for row in rows])

    # padded rows read 0, as in pandas' zero-padded frames
    timecodes, _ = pad_data(column(gt_header, gt_rows, "Timecode", str),
                            np.zeros(len(gen_rows)))
    plt.figure(figsize=(20, 20))
    for feature in features_to_plot:
        truth, generated = pad_data(column(gt_header, gt_rows, feature),
                                    column(gen_header, gen_rows, feature))
        plt.plot(timecodes[:512].astype(str), truth[:512],
                 label=f"Ground Truth {feature}")
        plt.plot(timecodes[:512].astype(str), generated[:512],
                 label=f"Generated {feature}", linestyle="dashed")
    plt.legend()
    plt.xticks(rotation=45)
    plt.xlabel("Timecode")
    plt.ylabel("Feature Value")
    plt.title("Comparison of Ground Truth and Generated Facial Features")
    plt.tight_layout()
    plt.savefig(output_image_path, dpi=100)
    plt.close()
    print(f"Comparison plot saved to {output_image_path}")


def split_csv_by_frames(input_csv_path: str, output_dir: str,
                        num_chunks: int = 4) -> list[str]:
    """Offline utility: split a capture CSV into chunks (reference:
    split_csv.py:7-38, its quirks kept: when the row count is not a multiple
    of num_chunks the rows are first mirror-padded to one, but chunk_size
    stays floor(pre-pad rows / num_chunks), so the last chunk takes every
    padded and remainder row)."""
    import os

    header, rows = read_csv_rows(input_csv_path)
    total = len(rows)
    chunk_size = total // num_chunks
    remainder = total % num_chunks
    if remainder != 0:
        rows = rows + rows[-(num_chunks - remainder):][::-1]
    total = len(rows)

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i in range(num_chunks):
        start = i * chunk_size
        end = (i + 1) * chunk_size if i < num_chunks - 1 else total
        path = os.path.join(
            output_dir,
            f"{os.path.basename(input_csv_path)[:-4]}_part{i + 1}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(rows[start:end])
        paths.append(path)
    return paths
