"""INI config-file parsing for the CLI.

Copy of ``emg3d_tpu/cli/parser.py``, plus one key: ``device`` in
``[solver_opts]`` (where the solves run; default CUDA).

Schema-driven: each section is declared as a {key: converter} table
and consumed generically by :class:`_Section`, which enforces the
strict unknown-key contract in one place.  The section/key/type schema
itself is the parity contract with the reference CLI
(emg3d/cli/parser.py); precedence is terminal args >
config file > defaults.
"""
import configparser
import os
from pathlib import Path

__all__ = ['parse_config_file']


# ----------------------------------------------------------------------
# Value converters (INI strings -> python values)
# ----------------------------------------------------------------------

_BOOL_STATES = {'1': True, 'yes': True, 'true': True, 'on': True,
                '0': False, 'no': False, 'false': False, 'off': False}


def _bool(s):
    try:
        return _BOOL_STATES[s.strip().lower()]
    except KeyError:
        raise ValueError(f"Not a boolean: {s!r}")


def _floats(s):
    return [float(v) for v in s.split(',')]


def _names(s):
    return [v.strip() for v in s.split(',')]


def _grouped_floats(s):
    """';'-separated groups of comma floats; 'none' groups -> None.

    A single group is returned bare, several as a tuple — the
    per-direction form of domain/distance/stretching/min_width_limits.
    """
    groups = [None if 'none' in g.lower() else _floats(g)
              for g in s.split(';')]
    return groups[0] if len(groups) == 1 else tuple(groups)


# ----------------------------------------------------------------------
# Section schemas
# ----------------------------------------------------------------------

_SIMULATION_KEYS = {'gridding': str, 'name': str, 'min_offset': float}

_SOLVER_KEYS = {
    'sslsolver': _bool, 'semicoarsening': _bool, 'linerelaxation': _bool,
    'cycle': str, 'tol': float,
    'verb': int, 'maxit': int, 'nu_init': int, 'nu_pre': int,
    'nu_coarse': int, 'nu_post': int, 'clevel': int,
    'device': str,
}

_DATA_KEYS = {'sources': _names, 'receivers': _names,
              'frequencies': _floats}

_GRIDDING_KEYS = {
    'properties': _floats, 'center': _floats, 'cell_number': _floats,
    'min_width_pps': _floats, 'expand': _floats,
    'domain': _grouped_floats, 'distance': _grouped_floats,
    'stretching': _grouped_floats, 'min_width_limits': _grouped_floats,
    'mapping': str, 'vector': str,
    'frequency': float, 'seasurface': float, 'max_buffer': float,
    'lambda_factor': float,
    'verb': int,
    'lambda_from_center': _bool,
}


class _Section:
    """One INI section with strict-unknown-key accounting."""

    def __init__(self, cfg, name):
        self.name = name
        self.pending = dict(cfg.items(name)) if cfg.has_section(name) \
            else {}

    def take(self, key, conv=str):
        """Pop and convert ``key``; None if absent."""
        if key not in self.pending:
            return None
        return conv(self.pending.pop(key))

    def collect(self, schema):
        """Pop every schema key that is present, converted."""
        return {k: self.take(k, conv) for k, conv in schema.items()
                if k in self.pending}

    def close(self):
        if self.pending:
            raise TypeError(f"Unexpected parameter in [{self.name}]: "
                            f"{list(self.pending)}")


def _terminal_args(args_dict, configfile):
    """Normalize the argparse dict; reject unconsumed keys."""
    term = {'config_file': configfile}
    for key in ('verbosity', 'nproc', 'dry_run', 'path', 'survey',
                'model', 'output'):
        term[key] = args_dict.pop(key)
    requested = [fn for fn in ('forward', 'misfit', 'gradient')
                 if args_dict.pop(fn)]
    term['function'] = requested[-1] if requested else 'forward'
    if args_dict:
        raise TypeError(f"Unexpected parameter in **args_dict: "
                        f"{list(args_dict)}")
    term['verbosity'] = int(min(max(term['verbosity'], -1), 2))
    if term['nproc'] is not None:
        term['nproc'] = max(int(term['nproc']), 1)
    return term


def _resolve_files(sec, term):
    """[files]: resolved absolute paths with default names/suffixes."""
    # Config keys are consumed unconditionally (strict accounting),
    # then terminal args take precedence over them.
    cfg_path = sec.take('path')
    path = os.path.abspath(term.pop('path') or cfg_path or '.')

    out = {}
    for key, default in (('survey', 'survey'), ('model', 'model'),
                         ('output', 'emg3d_out')):
        cfg_name = sec.take(key)
        name = term.pop(key) or cfg_name or default
        p = Path(path, name)
        if p.suffix not in ('.h5', '.json', '.npz'):
            p = p.with_suffix('.h5')
        out[key] = p

    files = {k: str(v) for k, v in out.items()}
    files['log'] = str(out['output'].with_suffix('.log'))
    files['store_simulation'] = sec.take('store_simulation',
                                         _bool) or False
    sec.close()
    return files


def parse_config_file(args_dict):
    """Read and parse the configuration file; merge terminal args.

    Returns ``({'files', 'simulation_options', 'data'}, term)`` — the
    same two-dict shape the reference CLI passes to its run module.
    """
    config = args_dict.pop('config')
    configfile = os.path.abspath(config)
    cfg = configparser.ConfigParser(inline_comment_prefixes='#')
    if os.path.isfile(configfile):
        with open(configfile) as fh:
            cfg.read_file(fh)
    elif config == '.':
        configfile = config

    term = _terminal_args(args_dict, configfile)
    files = _resolve_files(_Section(cfg, 'files'), term)

    # [simulation] — terminal --nproc wins over max_workers.
    sec = _Section(cfg, 'simulation')
    simulation = sec.collect(_SIMULATION_KEYS)
    workers = sec.take('max_workers', int)
    nproc = term.pop('nproc')
    if nproc is not None:
        simulation['max_workers'] = nproc
    elif workers is not None:
        simulation['max_workers'] = workers
    simulation.setdefault('name', 'emg3d_tpu_torch CLI run')
    sec.close()

    # [solver_opts] / [gridding_opts]: nested dicts, only if present.
    for section, schema, target in (
            ('solver_opts', _SOLVER_KEYS, 'solver_opts'),
            ('gridding_opts', _GRIDDING_KEYS, 'gridding_opts')):
        if cfg.has_section(section):
            sec = _Section(cfg, section)
            found = sec.collect(schema)
            sec.close()
            if found:
                simulation[target] = found

    # [data] — empty values are treated as absent (not converted).
    sec = _Section(cfg, 'data')
    data = {}
    for key, conv in _DATA_KEYS.items():
        raw = sec.pending.pop(key, None)
        if raw:
            data[key] = conv(raw)
    sec.close()

    return ({'files': files, 'simulation_options': simulation,
             'data': data}, term)
