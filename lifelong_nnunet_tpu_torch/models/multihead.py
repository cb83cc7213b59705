"""Multi-head (shared body / per-task heads) as a partition of the U-Net's
``state_dict``: the port of ``lifelong_nnunet_tpu/models/multihead.py``.

Keys are ``state_dict`` keys (``enc0.block0.conv.weight``, ``seg2.bias``,
...).  ``split_params`` orders them by the position of their top-level
module in the model's topological ``module_order()``, then by key, and cuts
at the FIRST key matching ``split_at``: that key and every later one form
the head, the rest the body (the reference's recursive split, its
``MultiHead_Module.py:159-324``, cited at ``models/multihead.py:71-87`` of
the JAX package).  The default split ``seg_outputs`` puts every ``seg*``
head in the head.  Tensors are cloned on the way in, so the optimizer's
in-place updates of the model never write through into the registry.

The freezing and name-filter masks (:meth:`MultiHeadParams.trainable_mask`,
:func:`name_filter_mask`) are plain ``{key: bool}`` dicts, and
:func:`replace_params` returns a new ``{key: tensor}`` dict: data only.
Wiring a mask into the optimizer comes with the trainers that freeze
parameters.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field, replace

# the reference's split-spec aliases: its default CL split is at the seg
# heads ('-s seg_outputs'); the U-Net's seg heads are seg0..segN
_SPEC_ALIASES = {"seg_outputs": "seg", "seg_outputs.0": "seg"}


def _normalize_spec(split_at: str) -> str:
    spec = split_at.strip().replace(" ", "").replace("/", ".")
    return _SPEC_ALIASES.get(split_at.strip(), _SPEC_ALIASES.get(spec, spec))


def _order_key(key: str, module_order: list):
    top = key.split(".")[0]
    idx = module_order.index(top) if top in module_order else len(module_order)
    return (idx, key)


def _match(key: str, spec: str) -> bool:
    top = key.split(".")[0]
    if spec == "seg":
        return top.startswith("seg")
    return key == spec or key.startswith(spec + ".") or top == spec


def _clone(sd: dict) -> dict:
    return {k: v.detach().clone() for k, v in sd.items()}


def split_params(state_dict: dict, split_at: str, module_order: list):
    """(body, head): the head is every key at or after (in topological
    order) the first key matching ``split_at``."""
    spec = _normalize_spec(split_at)
    ordered = sorted(state_dict, key=lambda k: _order_key(k, module_order))
    match = [i for i, k in enumerate(ordered) if _match(k, spec)]
    if not match:
        raise ValueError(
            f"split_at={split_at!r} (normalized {spec!r}) matches no parameter. "
            f"Top-level modules: {sorted({k.split('.')[0] for k in ordered})}")
    cut = match[0]
    return ({k: state_dict[k] for k in ordered[:cut]},
            {k: state_dict[k] for k in ordered[cut:]})


@dataclass
class MultiHeadParams:
    """The whole multi-head network state: shared body + per-task heads;
    ``state_init`` keeps the freshly initialized head for Multi-Head-style
    task addition."""
    body: dict
    heads: "OrderedDict[str, dict]"
    split_at: str
    module_order: list
    state_init: dict = field(default_factory=dict)
    active_task: str = ""

    @staticmethod
    def create(state_dict: dict, split_at: str, module_order: list,
               task: str) -> "MultiHeadParams":
        body, head = split_params(_clone(state_dict), split_at, module_order)
        return MultiHeadParams(body=body, heads=OrderedDict({task: head}),
                               split_at=split_at, module_order=list(module_order),
                               state_init=_clone(head), active_task=task)

    def add_new_task(self, task: str, use_init: bool = True) -> "MultiHeadParams":
        """New head from ``state_init`` (Multi-Head) or from the active head
        (Sequential / transfer heads); an existing task is only activated."""
        if task in self.heads:
            return replace(self, active_task=task)
        src = self.state_init if use_init and self.state_init \
            else self.heads[self.active_task]
        heads = OrderedDict(self.heads)
        heads[task] = _clone(src)
        return replace(self, heads=heads, active_task=task)

    def add_n_tasks_and_activate(self, tasks: list, active: str,
                                 use_init: bool = True) -> "MultiHeadParams":
        """Add every task of ``tasks`` not yet registered, in order, then
        activate ``active`` (restoring a checkpoint, ``--init_seq``)."""
        mh = self
        for t in tasks:
            mh = mh.add_new_task(t, use_init=use_init)
        return replace(mh, active_task=active)

    def assemble(self, task: str | None = None) -> dict:
        """The full ``state_dict`` of one task: body and its head."""
        merged = dict(self.body)
        merged.update(self.heads[task or self.active_task])
        return merged

    def absorb(self, state_dict: dict, task: str | None = None) -> "MultiHeadParams":
        """Write trained parameters back into the body and ``heads[task]``
        (at epoch and task boundaries, not per iteration)."""
        body, head = split_params(_clone(state_dict), self.split_at, self.module_order)
        heads = OrderedDict(self.heads)
        heads[task or self.active_task] = head
        return replace(self, body=body, heads=heads)

    def trainable_mask(self, freeze_body: bool = False) -> dict:
        """``{key: bool}`` over the assembled ``state_dict``: False marks a
        frozen parameter (the body's with ``freeze_body``)."""
        mask = {k: not freeze_body for k in self.body}
        mask.update({k: True for k in self.heads[self.active_task]})
        return mask

    @property
    def tasks(self) -> list:
        return list(self.heads)


def replace_params(state_dict: dict, predicate, fn) -> dict:
    """A new dict with ``fn(value)`` for every key where ``predicate(key)``
    holds and the other values as they are (the reference's
    ``replace_layers``, ``MultiHead_Module.py:544-572``)."""
    return {k: (fn(v) if predicate(k) else v) for k, v in state_dict.items()}


def name_filter_mask(state_dict: dict, substrings: list, include: bool) -> dict:
    """``{key: bool}``: True where the key contains every one of
    ``substrings`` (case-insensitive) with ``include``, where it does not
    without (the EWC variants' parameter-name filters)."""
    out = {}
    for k in state_dict:
        hit = all(s.lower() in k.lower() for s in substrings)
        out[k] = hit if include else not hit
    return out

