"""Output voxels one pass computes over the volume's output voxels: how
many times the predictor computes each voxel it writes (a count)."""


def read(record: dict):
    if record.get("kind") != "predict":
        return None
    return record["computed_voxels_per_pass"] / record["volume_voxels"]
