"""Config system: YAML with ``_BASE_CONFIG_`` inheritance and dotted CLI overrides.

The port's own copy of ``q3d_tpu/config.py`` (that package imports JAX on
import, so the port cannot import it).  ``_BASE_CONFIG_`` paths still resolve
against the repo's ``tools/`` directory, which both packages share.

Capability parity with the reference config layer (``pcdet/config.py:16-85``):
  * attribute-access nested dict (reference uses the ``easydict`` pip package);
  * ``cfg_from_yaml_file`` merging a model cfg over its ``_BASE_CONFIG_`` include;
  * ``cfg_from_list`` dotted-path overrides with literal-eval type enforcement;
  * a module-global ``cfg`` singleton plus ``ROOT_DIR``/``LOCAL_RANK``.

Re-designed details: base-config paths resolve relative to the including file,
then ``<repo>/tools``, then CWD (the reference only supports CWD==tools/).
"""

import copy
from ast import literal_eval
from pathlib import Path

import yaml


class EDict(dict):
    """Attribute-access dict (drop-in for easydict.EasyDict)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _convert(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._convert(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._convert(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise AttributeError(k)

    def update(self, other=None, **kwargs):
        other = dict(other or {}, **kwargs)
        for k, v in other.items():
            self[k] = v

    def __deepcopy__(self, memo):
        return EDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _resolve_base_path(base, cfg_file):
    """Resolve a ``_BASE_CONFIG_`` path against likely roots."""
    base = Path(base)
    if base.is_absolute() and base.exists():
        return base
    candidates = []
    if cfg_file is not None:
        cfg_dir = Path(cfg_file).resolve().parent
        # walk up so 'cfgs/dataset_configs/x.yaml' resolves from any cfg depth
        for up in [cfg_dir, *cfg_dir.parents]:
            candidates.append(up / base)
    candidates.append(ROOT_DIR / "tools" / base)
    candidates.append(Path.cwd() / base)
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(f"_BASE_CONFIG_ {base} not found (tried {len(candidates)} roots)")


def merge_new_config(config, new_config, cfg_file=None):
    """Merge ``new_config`` over ``config``; honors ``_BASE_CONFIG_`` includes
    (same semantics as reference ``pcdet/config.py:55-70``)."""
    if "_BASE_CONFIG_" in new_config:
        base_path = _resolve_base_path(new_config["_BASE_CONFIG_"], cfg_file)
        base_cfg = _load_yaml(base_path)
        # base is merged recursively too (bases may include bases)
        merge_new_config(config, base_cfg, cfg_file=base_path)

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config or not isinstance(config[key], dict):
            config[key] = EDict()
        merge_new_config(config[key], val, cfg_file=cfg_file)
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    if config is None:
        config = cfg
    new_config = _load_yaml(cfg_file)
    merge_new_config(config=config, new_config=new_config, cfg_file=cfg_file)
    return config


def cfg_from_list(cfg_list, config=None):
    """Dotted-path overrides: ``['MODEL.DENSE_HEAD.NMS_CONFIG.SCORE_THRESH','0.2']``.

    Type-enforced against the existing value like the reference
    (``pcdet/config.py:16-52``), including the ``k1:v1,k2:v2`` dict form and
    comma-separated list form.
    """
    if config is None:
        config = cfg
    assert len(cfg_list) % 2 == 0, "override list must be KEY VALUE pairs"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f"NotFoundKey: {subkey}"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"NotFoundKey: {subkey}"
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        old = d[subkey]
        if type(value) != type(old) and isinstance(old, dict):
            for item in value.split(","):
                ck, cv = item.split(":")
                d[subkey][ck] = type(old[ck])(cv)
        elif type(value) != type(old) and isinstance(old, list):
            d[subkey] = [type(old[0])(x) for x in value.split(",")]
        else:
            assert type(value) == type(old), (
                f"type {type(value)} does not match original type {type(old)}")
            d[subkey] = value
    return config


ROOT_DIR = Path(__file__).resolve().parent.parent
cfg = EDict()
