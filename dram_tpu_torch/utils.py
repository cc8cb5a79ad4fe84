"""Settings and small host-side helpers of the port.

Port of dram_tpu/utils.py: `convert_dict_string` (:21), `Settings` (:34),
the CSV readers `read_csv_in_dict` (:317) and `read_csv_in_dict_double`
(:329), `get_value_recursively` (:341), the meters and loggers
`AverageMeter` (:360), `MovingAverage` (:379), `Timer` (:390) and
`PD_Stats` (:398, pandas imported when one is made), `expand_dims_np` /
`squeeze_dims_np` (:415-427), `count_params` (:430, over an nn.Module or
a dict of tensors) and `estimate_conv3d_macs` (:438), and the records.csv
writer of the runners (`write_records`, the layout pandas writes).
Settings are plain Python modules whose UPPERCASE names become
attributes; `Settings` also lifts them from an imported settings module
or a dram_tpu_torch.configs.with_settings namespace, so that a caller can
build settings in code.
"""

from __future__ import annotations

import csv
import importlib.util
import math
import os
import time


def convert_dict_string(d, i=1):
    sp = "    " * i
    sp0 = "    " * (i - 1)
    s = f"\n{sp0}{{"
    for k, v in d.items():
        if isinstance(v, dict):
            s += f"\n{sp}{k}:{convert_dict_string(v, i + 1)}"
        else:
            s += f"\n{sp}{k}:{v}"
    s += f"\n{sp0}}}"
    return s


class Settings:
    """UPPERCASE names of a settings module as mutable attributes.

    `source` is a settings file's path (exec-loaded, as the JAX package's
    Settings does), an imported settings module or a namespace such as
    with_settings returns; the names are copied, so setting an attribute
    leaves the source unchanged. `EXP_NAME` is compulsory,
    `is_overridden` reports which settings were explicit, and
    `str(settings)` pretty-prints them (the runner's settings.txt)."""

    COMPULSORY = ("EXP_NAME",)

    def __init__(self, source, settings_name="settings"):
        if isinstance(source, (str, os.PathLike)):
            self.settings_module_path = str(source)
            spec = importlib.util.spec_from_file_location(settings_name,
                                                          str(source))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        else:
            self.settings_module_path = getattr(source, "__file__", None)
            mod = source

        self._explicit_settings = set()
        # (a Settings' own class constants are not settings)
        for setting in dir(mod):
            if setting.isupper() and not hasattr(Settings, setting):
                value = getattr(mod, setting)
                if setting in self.COMPULSORY and value is None:
                    raise AttributeError(
                        f"The {setting} setting must be not None.")
                setattr(self, setting, value)
                self._explicit_settings.add(setting)
        for setting in self.COMPULSORY:
            if not hasattr(self, setting):
                raise AttributeError(f"Settings module must define {setting}.")

    def is_overridden(self, setting):
        return setting in self._explicit_settings

    def get(self, name, default=None):
        return getattr(self, name, default)

    def __str__(self):
        d = {k: v for k, v in self.__dict__.items() if k.isupper()}
        return convert_dict_string(d)


def read_csv_in_dict(csv_file_path, column_key, fieldnames=None):
    """Rows of a CSV file keyed by one column: ({key: row}, field names);
    ({}, None) when the file does not exist."""
    row_dict = {}
    if not os.path.exists(csv_file_path):
        return row_dict, None
    with open(csv_file_path, "rt") as fp:
        cr = csv.DictReader(fp, delimiter=",", fieldnames=fieldnames)
        for row in cr:
            row_dict[row[column_key]] = row
        field_names = cr.fieldnames
    return row_dict, field_names


def read_csv_in_dict_double(csv_file_path, column_keys, fieldnames=None):
    """As read_csv_in_dict, keyed by a tuple of columns."""
    row_dict = {}
    if not os.path.exists(csv_file_path):
        return row_dict, None
    with open(csv_file_path, "rt") as fp:
        cr = csv.DictReader(fp, delimiter=",", fieldnames=fieldnames)
        for row in cr:
            row_dict[tuple(row[k] for k in column_keys)] = row
        field_names = cr.fieldnames
    return row_dict, field_names


def _csv_value(v):
    """A records.csv cell as pandas writes it: NaN as an empty cell."""
    if isinstance(v, float) and math.isnan(v):
        return ""
    return v


def write_records(path, rows, first):
    """Rows (dicts) as a CSV file in the layout pandas' to_csv(index=False)
    gives a DataFrame built from them: the column `first`, then the other
    keys in the order they first appear; a missing cell is empty."""
    fields = [first]
    for row in rows:
        fields += [k for k in row if k not in fields]
    with open(path, "wt", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows({k: _csv_value(v) for k, v in row.items()}
                    for row in rows)


def get_value_recursively(search_dict, field):
    """Every value stored under key `field` in a nested dict/list tree."""
    found = []
    for key, value in search_dict.items():
        if key == field:
            found.append(value)
        elif isinstance(value, dict):
            found.extend(get_value_recursively(value, field))
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, dict):
                    found.extend(get_value_recursively(item, field))
    return found


class AverageMeter:
    """Stores current value, running sum and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MovingAverage:
    """Exponential moving average with weight `inertia` on the past."""

    def __init__(self, inertia=0.9):
        self.inertia = inertia
        self.reset()

    def reset(self):
        self.avg = 0.0

    def update(self, val):
        self.avg = self.inertia * self.avg + (1 - self.inertia) * val


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def elapsed(self):
        return time.time() - self.t0


class PD_Stats:
    """A pandas DataFrame of rows pickled to `path` at each update,
    resumed from the pickle when it exists (its columns must match)."""

    def __init__(self, path, columns):
        import pandas as pd
        self.path = path
        if os.path.isfile(path):
            self.stats = pd.read_pickle(path)
            assert list(self.stats.columns) == list(columns)
        else:
            self.stats = pd.DataFrame(columns=columns)

    def update(self, row, save=True):
        self.stats.loc[len(self.stats.index)] = row
        if save:
            self.stats.to_pickle(self.path)


def expand_dims_np(a, expected_dim):
    """Prepend singleton axes until `a` has `expected_dim` axes."""
    while a.ndim < expected_dim:
        a = a[None]
    return a


def squeeze_dims_np(a, expected_dim, squeeze_start_index=0):
    """Squeeze axis `squeeze_start_index` until `a` has `expected_dim`
    axes."""
    while a.ndim > expected_dim:
        a = a.squeeze(squeeze_start_index)
    return a


def count_params(tree):
    """Parameter count of an nn.Module (its parameters) or of a (nested)
    dict, list or tuple of arrays or tensors."""
    if hasattr(tree, "parameters"):
        return int(sum(p.numel() for p in tree.parameters()))
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(math.prod(tree.shape))


def estimate_conv3d_macs(model_cfg, spatial_size):
    """Rough MAC count of the DC3D channel plan (n_layers,
    base_ch_list, end_ch_list, in_ch_list) at a chunk size: over the
    conv stacks, output voxels * 27 * (c_in * base + base * end)."""
    n = model_cfg["n_layers"]
    base = model_cfg["base_ch_list"]
    end = model_cfg["end_ch_list"]
    in_ch = model_cfg["in_ch_list"]
    macs = 0
    size = [int(s) for s in spatial_size]
    for i in range(n):  # encoder, full size down
        macs += math.prod(size) * 27 * (in_ch[i] * base[i] + base[i] * end[i])
        size = [s // 2 for s in size]
    macs += math.prod(size) * 27 * (in_ch[n] * base[n] + base[n] * end[n])
    for i in range(n):  # decoder
        size = [s * 2 for s in size]
        li = n + 1 + i
        macs += math.prod(size) * 27 * (in_ch[li] * base[li]
                                        + base[li] * end[li])
    return macs
