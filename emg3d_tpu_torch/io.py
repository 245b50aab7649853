"""Unified persistence: save/load to .h5, .npz, and .json.

Copy of ``emg3d_tpu/io.py`` (numpy, and h5py where it is installed)
with the port's classes.  The formats are those of the JAX package and
of the reference (emg3d/io.py): hierarchical h5 groups, npz with
'>'-joined flattened keys, json with ``__complex`` / ``__array-<dtype>``
tagged lists; instances of the KNOWN_CLASSES are (de)serialized via
their to_dict/from_dict, and None is stored as the string sentinel
'NoneType'.  The two packages' ``to_dict``s agree, so a file written by
either loads in the other.
"""
import json
import os
from datetime import datetime

import numpy as np

try:
    import h5py
except ImportError:
    h5py = None

from . import fields, maps, meshes, models
from . import __version__

__all__ = ['save', 'load', 'KNOWN_CLASSES']


def _known_classes():
    from . import surveys, simulations
    return {
        'Map': maps._Map,
        'Model': models.Model,
        'Field': fields.Field,
        'SourceField': fields.SourceField,
        'TensorMesh': meshes.TensorMesh,
        'Survey': surveys.Survey,
        'Dipole': surveys.Dipole,
        'Simulation': simulations.Simulation,
    }


def __getattr__(name):
    # KNOWN_CLASSES is resolved lazily (PEP 562): surveys/simulations
    # import io, so building the dict at import time would be circular.
    if name == 'KNOWN_CLASSES':
        return _known_classes()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def save(fname, **kwargs):
    """Save any number of named objects/arrays to ``fname``.

    Backend chosen by extension: .h5 (default), .npz, .json.
    Known-class instances are stored via ``to_dict`` and restored on
    load.
    """
    compression = kwargs.pop('compression', 'gzip')
    json_indent = kwargs.pop('json_indent', 2)
    kwargs.pop('collect_classes', False)
    verb = kwargs.pop('verb', 0)

    full_path, ext = _path_ext(fname)

    data = {}
    for key, value in kwargs.items():
        data[key] = _serialize(value)

    data['_date'] = datetime.today().isoformat()
    data['_version'] = f"emg3d_tpu_torch v{__version__}"
    data['_format'] = ext

    if ext == 'h5':
        if h5py is None:
            raise ImportError("h5py is required for .h5 files.")
        with h5py.File(full_path, 'w') as h5file:
            _dict_to_h5(h5file, data, compression)
    elif ext == 'npz':
        flat = {}
        _flatten(data, '', flat)
        np.savez_compressed(full_path, **flat)
    elif ext == 'json':
        jdata = _jsonify(data)
        with open(full_path, 'w') as f:
            json.dump(jdata, f, indent=json_indent)
    else:
        raise ValueError(f"Unknown extension '.{ext}'; use h5/npz/json.")

    if verb > 0:
        print(f"Data saved to «{full_path}»")


def load(fname, **kwargs):
    """Load a file saved with :func:`save`; returns dict of objects."""
    verb = kwargs.pop('verb', 0)
    if kwargs:
        raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}")

    full_path, ext = _path_ext(fname)

    if ext == 'h5':
        if h5py is None:
            raise ImportError("h5py is required for .h5 files.")
        with h5py.File(full_path, 'r') as h5file:
            data = _h5_to_dict(h5file)
    elif ext == 'npz':
        npz = np.load(full_path, allow_pickle=False)
        data = {}
        for key in npz.files:
            _insert_nested(data, key.split('>'), npz[key])
    elif ext == 'json':
        with open(full_path, 'r') as f:
            data = _unjsonify(json.load(f))
    else:
        raise ValueError(f"Unknown extension '.{ext}'; use h5/npz/json.")

    out = {k: _deserialize(v) for k, v in data.items()}

    if verb > 0:
        print(f"Data loaded from «{full_path}»")
    return out


# ----------------------------------------------------------------------
# (De)serialization of known classes / sentinels
# ----------------------------------------------------------------------

def _serialize(value):
    cls = _known_classes()
    for cname, ctype in cls.items():
        if isinstance(value, ctype):
            return _serialize(value.to_dict())
    if value is None:
        return 'NoneType'
    if isinstance(value, dict):
        return {str(k): _serialize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        # Raises for arrays of equal leading and unequal trailing shapes,
        # as the JAX package does.
        np.asarray(value, dtype=object)
        try:
            return np.asarray(value)
        except (ValueError, TypeError):
            return {f"#{i}": _serialize(v) for i, v in enumerate(value)}
    return value


def _deserialize(value):
    if isinstance(value, np.ndarray) and value.dtype.kind == 'U':
        if value.shape == () and str(value) == 'NoneType':
            return None
        if value.shape == ():
            return str(value)
        return value
    if isinstance(value, str) and value == 'NoneType':
        return None
    if isinstance(value, dict):
        sub = {k: _deserialize(v) for k, v in value.items()}
        cname = sub.get('__class__', None)
        if cname is not None:
            cname = str(cname)
            cls = _known_classes()
            if cname in cls:
                return cls[cname].from_dict(sub)
            if cname.startswith('Map'):
                return maps.MAPLIST[cname[3:]]()
        return sub
    return value


# ----------------------------------------------------------------------
# Backends
# ----------------------------------------------------------------------

def _path_ext(fname):
    ext = fname.split('.')[-1].lower()
    if ext not in ['h5', 'npz', 'json']:
        ext = 'h5'
        fname = fname + '.h5'
    return fname, ext


def _dict_to_h5(grp, data, compression):
    for key, value in data.items():
        key = str(key)
        if isinstance(value, dict):
            sub = grp.create_group(key)
            _dict_to_h5(sub, value, compression)
        elif value is None:
            grp[key] = 'NoneType'
        elif isinstance(value, str):
            grp[key] = value
        elif isinstance(value, np.ndarray) and value.size > 1:
            grp.create_dataset(key, data=value, compression=compression)
        else:
            grp[key] = value


def _h5_to_dict(grp):
    out = {}
    for key, value in grp.items():
        if isinstance(value, type(grp)) or hasattr(value, 'items'):
            out[key] = _h5_to_dict(value)
        else:
            v = value[()]
            if isinstance(v, bytes):
                v = v.decode()
            out[key] = v
    return out


def _flatten(data, prefix, out):
    for key, value in data.items():
        key = str(key)
        name = f"{prefix}>{key}" if prefix else key
        if isinstance(value, dict):
            _flatten(value, name, out)
        elif value is None:
            out[name] = np.array('NoneType')
        else:
            out[name] = np.asarray(value)


def _insert_nested(data, keys, value):
    cur = data
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    v = value
    if v.dtype.kind == 'U' and v.shape == ():
        v = str(v)
        if v == 'NoneType':
            v = None
    elif v.shape == ():
        v = v[()]
    cur[keys[-1]] = v


def _jsonify(value):
    if isinstance(value, dict):
        return {str(k): _jsonify(v) for k, v in value.items()}
    if value is None:
        return 'NoneType'
    if isinstance(value, np.ndarray):
        if np.iscomplexobj(value):
            return {'__complex': [value.real.tolist(),
                                  value.imag.tolist()]}
        return {f'__array-{value.dtype.name}': value.tolist()}
    if isinstance(value, complex):
        return {'__complex': [value.real, value.imag]}
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


def _unjsonify(value):
    if isinstance(value, dict):
        if '__complex' in value and len(value) == 1:
            re_, im_ = value['__complex']
            return np.asarray(re_) + 1j * np.asarray(im_)
        for k in list(value.keys()):
            if k.startswith('__array-') and len(value) == 1:
                return np.asarray(value[k], dtype=k[8:])
        return {k: _unjsonify(v) for k, v in value.items()}
    if isinstance(value, str) and value == 'NoneType':
        return None
    if isinstance(value, list):
        try:
            arr = np.asarray(value, dtype=np.float64)
            return arr
        except (ValueError, TypeError):
            return [_unjsonify(v) for v in value]
    return value


def _compare_dicts(dict1, dict2, verb=False, **kwargs):
    """Recursively compare two dicts (dev helper; reference io.py:692).
    """
    equal = True
    keys = set(dict1.keys()) | set(dict2.keys())
    for key in keys:
        if key not in dict1 or key not in dict2:
            equal = False
            if verb:
                print(f"Key {key} missing in one dict.")
            continue
        v1, v2 = dict1[key], dict2[key]
        if isinstance(v1, dict) and isinstance(v2, dict):
            equal = _compare_dicts(v1, v2, verb) and equal
        else:
            try:
                same = np.allclose(np.asarray(v1, dtype=float),
                                   np.asarray(v2, dtype=float))
            except (ValueError, TypeError):
                same = np.all(np.asarray(v1) == np.asarray(v2))
            if not same:
                equal = False
                if verb:
                    print(f"Key {key} differs.")
    return equal
