"""Config / flag system: reflection-based argparse groups and the persisted
``cfg_args`` namespace of the reference (arguments/__init__.py:16-120,
train_unified_lift.py:502-514), read with ast.literal_eval instead of eval() —
same on-disk format, no code execution."""

from __future__ import annotations

import ast
import json
import os
from argparse import ArgumentParser, Namespace


class ParamGroup:
    """Every non-underscore attribute becomes ``--name``; a leading underscore
    adds the one-letter shorthand ``-n``. bool attrs become store_true flags."""

    def __init__(self, parser: ArgumentParser, name: str, fill_none: bool = False):
        group = parser.add_argument_group(name)
        if not hasattr(parser, "_sentinel_defaults"):
            parser._sentinel_defaults = {}
        for key, value in vars(self).items():
            shorthand = False
            if key.startswith("_"):
                shorthand = True
                key = key[1:]
            t = type(value)
            if fill_none:
                # the real default is kept so get_combined_args can fall back
                # to it when the model dir has no cfg_args; the parser default
                # stays None as the "not given on the command line" sentinel
                parser._sentinel_defaults[key] = value
                value = None
            names = [f"--{key}"] + ([f"-{key[0:1]}"] if shorthand else [])
            if t is bool:
                group.add_argument(*names, default=value, action="store_true")
            else:
                group.add_argument(*names, default=value, type=t)

    def extract(self, args) -> Namespace:
        """This group's values out of the parsed ``args``."""
        out = Namespace()
        for key in vars(self):
            k = key.lstrip("_")
            if hasattr(args, k):
                setattr(out, k, getattr(args, k))
        return out


class ModelParams(ParamGroup):
    """Scene/model CLI group (reference arguments/__init__.py:44-64)."""

    def __init__(self, parser: ArgumentParser, sentinel: bool = False):
        self.sh_degree = 3
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._object_path = "object_mask"
        self._resolution = -1
        self._white_background = False
        self.train_split = False
        self.data_device = "cuda"
        self.eval = False
        self.n_views = 0
        self.random_init = False
        self.train_test_exp = False
        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args) -> Namespace:
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path) if g.source_path else ""
        return g


class PipelineParams(ParamGroup):
    """(reference arguments/__init__.py:66-71)"""

    def __init__(self, parser: ArgumentParser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    """(reference arguments/__init__.py:73-98)"""

    def __init__(self, parser: ArgumentParser):
        self.iterations = 30_000
        self.position_lr_init = 0.00016
        self.position_lr_final = 0.0000016
        self.position_lr_delay_mult = 0.01
        self.position_lr_max_steps = 30_000
        self.feature_lr = 0.0025
        self.opacity_lr = 0.05
        self.scaling_lr = 0.005
        self.rotation_lr = 0.001
        self.percent_dense = 0.01
        self.lambda_dssim = 0.2
        self.densification_interval = 100
        self.opacity_reset_interval = 3000
        self.densify_from_iter = 500
        self.densify_until_iter = 15_000
        self.densify_grad_threshold = 0.0002
        self.reg3d_interval = 2
        self.reg3d_k = 5
        self.reg3d_lambda_val = 2
        self.reg3d_max_points = 300_000
        self.reg3d_sample_size = 1000
        super().__init__(parser, "Optimization Parameters")


def save_cfg_args(model_path: str, args: Namespace) -> None:
    """Persist the run config as the reference does: ``cfg_args`` holding the
    Namespace repr."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args))


def _parse_namespace_repr(text: str) -> Namespace:
    """Parse ``Namespace(a=1, b='x')`` without eval(). Values must be Python
    literals, which is all argparse produces."""
    text = text.strip()
    if not (text.startswith("Namespace(") and text.endswith(")")):
        raise ValueError("not a Namespace repr")
    call = ast.parse(text, mode="eval").body
    if not (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "Namespace"):
        raise ValueError("not a Namespace call")
    return Namespace(**{kw.arg: ast.literal_eval(kw.value) for kw in call.keywords})


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI args over the model dir's saved ``cfg_args``."""
    cmdline = parser.parse_args(argv)
    cfg = Namespace()
    try:
        path = os.path.join(cmdline.model_path, "cfg_args")
        with open(path) as f:
            print(f"Looking for config file in {path}")
            cfg = _parse_namespace_repr(f.read())
            print(f"Config file found: {path}")
    except (FileNotFoundError, TypeError, AttributeError, ValueError):
        print("Config file not found at model path")
    merged = vars(cfg).copy()
    for k, v in vars(cmdline).items():
        if v is not None:
            merged[k] = v
    # sentinel params resolved neither by CLI nor cfg_args fall back to their
    # real defaults instead of vanishing from the namespace
    for k, v in getattr(parser, "_sentinel_defaults", {}).items():
        merged.setdefault(k, v)
    return Namespace(**merged)


def load_json_config(path: str, args: Namespace) -> Namespace:
    """Overlay a JSON config file onto ``args`` (the reference's
    train_unified_lift.py:549-566)."""
    with open(path) as f:
        cfg = json.load(f)
    for k, v in cfg.items():
        setattr(args, k, v)
    return args
