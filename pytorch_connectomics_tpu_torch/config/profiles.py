"""Profile expansion engine.

Reproduces the semantics of the reference's ``YamlProfileEngine``
(``config/pipeline/profile_engine.py:438``): named profiles live in top-level
registries (``*_profiles`` keys, loaded via ``_base_`` chains); a ``profile:``
selector inside a section pulls the named payload in as *defaults* (explicit
YAML values win); ``pipeline_profile`` applies a multi-section patch at a
stage root; ``template:`` entries in ``decoding.steps`` expand from
``decoding_templates``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from .merge import deep_merge, get_path, set_path

# (registry_key, stage_scopes, selector_rel, target_rel)
# stage scope "" = root-level section, others are stage blocks.
_STAGES_ALL = ("default", "train", "test", "tune", "")
_VALUE_PROFILE_FAMILIES: List[Tuple[str, Tuple[str, ...], str, str]] = [
    ("pipeline_profiles", ("default", "train", "test", "tune", ""), "pipeline_profile", ""),
    ("system_profiles", _STAGES_ALL, "system.profile", "system"),
    ("arch_profiles", _STAGES_ALL, "model.arch.profile", "model"),
    ("augmentation_profiles", ("default", "train", ""), "data.augmentation.profile", "data.augmentation"),
    ("dataloader_profiles", _STAGES_ALL, "data.dataloader.profile", "data.dataloader"),
    ("optimizer_profiles", ("default", "train", ""), "optimization.profile", "optimization"),
    ("loss_profiles", ("default", "train", ""), "model.loss.profile", "model.loss"),
    ("label_profiles", ("default", "train", ""), "data.label_transform.profile", "data.label_transform"),
    (
        "activation_profiles",
        ("default", "test", "tune", ""),
        "inference.model.activation_profile",
        "inference.model",
    ),
    ("tune_profiles", ("tune",), "profile", ""),
]

REGISTRY_KEYS = sorted({fam[0] for fam in _VALUE_PROFILE_FAMILIES} | {"decoding_templates"})


class ProfileError(ValueError):
    pass


def _stage_path(stage: str, rel: str) -> str:
    if not stage:
        return rel
    return f"{stage}.{rel}" if rel else stage


def _pop_path(d: Dict[str, Any], path: str):
    parts = path.split(".")
    node = d
    for part in parts[:-1]:
        node = node.get(part) if isinstance(node, dict) else None
        if node is None:
            return None
    if isinstance(node, dict):
        return node.pop(parts[-1], None)
    return None


def split_registries(raw: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Pop ``*_profiles`` / ``decoding_templates`` registries off the root."""
    registries = {}
    for key in list(raw.keys()):
        if key in REGISTRY_KEYS or key.endswith("_profiles"):
            registries[key] = raw.pop(key)
    return raw, registries


def _lookup(registries: Dict[str, Any], registry_key: str, name: str, selector_path: str):
    registry = registries.get(registry_key) or {}
    if name not in registry:
        known = sorted(registry)
        raise ProfileError(
            f"Unknown selector '{name}' at '{selector_path}'. Known {registry_key}: {known}"
        )
    return copy.deepcopy(registry[name])


def expand_profiles(raw: Dict[str, Any], registries: Dict[str, Any]) -> Dict[str, Any]:
    """Expand all profile selectors in ``raw`` (non-mutating).

    Profiles merge as defaults beneath existing explicit values. Iterates to a
    fixed point because profile payloads may themselves contain selectors
    (e.g. ``pipeline_profiles.binary`` sets ``model.loss.profile``).
    """
    out = copy.deepcopy(raw)
    for _ in range(8):  # nested profile chains are shallow
        changed = False
        for registry_key, stages, selector_rel, target_rel in _VALUE_PROFILE_FAMILIES:
            for stage in stages:
                sel_path = _stage_path(stage, selector_rel)
                name = get_path(out, sel_path)
                if not name or not isinstance(name, str):
                    continue
                payload = _lookup(registries, registry_key, name, sel_path)
                _pop_path(out, sel_path)
                target_path = _stage_path(stage, target_rel)
                if target_path:
                    existing = get_path(out, target_path) or {}
                    set_path(out, target_path, deep_merge(payload, existing))
                else:
                    merged = deep_merge(payload, out)
                    out.clear()
                    out.update(merged)
                changed = True
        if _expand_decoding_templates(out, registries):
            changed = True
        if not changed:
            break
    return out


def _expand_decoding_templates(out: Dict[str, Any], registries: Dict[str, Any]) -> bool:
    """Expand ``{template: name}`` entries in any ``decoding.steps`` list
    (reference list-template applier, ``profile_engine.py:346``)."""
    changed = False
    for stage in ("", "default", "train", "test", "tune"):
        path = _stage_path(stage, "decoding.steps")
        steps = get_path(out, path)
        if not isinstance(steps, list):
            continue
        new_steps: List[Any] = []
        for step in steps:
            if isinstance(step, dict) and "template" in step:
                name = step["template"]
                payload = _lookup(registries, "decoding_templates", name, path)
                tmpl_steps = payload.get("steps", [payload]) if isinstance(payload, dict) else payload
                if isinstance(tmpl_steps, dict):
                    tmpl_steps = [tmpl_steps]
                overrides = {k: v for k, v in step.items() if k != "template"}
                for t in tmpl_steps:
                    new_steps.append(deep_merge(t, overrides))
                changed = True
            else:
                new_steps.append(step)
        if changed:
            set_path(out, path, new_steps)
    return changed
