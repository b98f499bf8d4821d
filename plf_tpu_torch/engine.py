"""High-level PLF engine: one PLF call, a batch of them, and the golden
check.  Counterpart of ``plf_tpu/engine.py``.

* ``plf()``       -- one PLF call (site batch -> parent CLV + scalers)
* ``plf_batch()`` -- I independent node-pairs in one launch (kernel 1 or
                     1m with an instance axis)
* ``plf()``       -- the module-level one-shot call with a default engine
* ``verify()``    -- golden-model comparison with the reference's exact
                     float-equality criterion (``host_mem.cpp:403-442``)

Inputs may be NumPy arrays or tensors; they are placed on the engine's
``device`` ("cuda" unless the caller asks for "cpu").  On a CUDA device
``Backend.KERNEL`` runs kernel 1 ("vpu" at S = 4) or kernel 1m (every MXU
variant, and "vpu" at other S), on the CPU their plain versions.  "vpu"
and "mxu" keep the golden model's fp32 order, so ``verify`` is exact by
default for them; "mxu_3x" and "mxu_bf16" carry their error classes
(about 1e-5 and 1e-2 relative), which ``verify``'s bars do not admit.

``PLFConfig(dtype="bfloat16")`` is honoured where the JAX engine honours
it: ``plf()`` on ``Backend.KERNEL`` stores the padded CLVs and the parent
in bf16 (kernels 1 and 1m read and write bf16 rows, fp32 arithmetic) and
returns a bf16 ``x3``; ``plf_batch()``, ``Backend.TORCH`` and
``Backend.REFERENCE`` stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .config import Backend, PLFConfig
from .ops import layout as L
from .ops.plf_node import plf_node_batch, plf_node_site_major
from .ops.plf_torch import plf_torch
from .reference import plf_reference

__all__ = ["PLFEngine", "PLFResult", "plf"]


@dataclasses.dataclass
class PLFResult:
    """Outputs of one PLF call."""

    x3: torch.Tensor                # (n, C, S) parent CLV
    scaler_vector: torch.Tensor     # (n,) int32 per-site rescale flags
    scaler_increment: torch.Tensor  # () int64 weighted sum


class PLFEngine:
    """Configured PLF evaluator.

    Example::

        eng = PLFEngine(PLFConfig())            # on the card
        out = eng.plf(x1, x2, left, right, ev, wgt)
    """

    def __init__(self, config: Optional[PLFConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or PLFConfig()
        self.device = torch.device(device)

    def _t(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- geometry / config report --------------------------------------------

    def geometry(self, n_sites: int, plf_calls: int = 1,
                 instances: int = 1) -> dict:
        """Buffer geometry for a workload (lane-major device buffers) of
        ``instances`` node-pairs per ``plf_batch`` call."""
        cfg = self.config
        e = cfg.elements_per_site
        n_pad = L.sites_padding(n_sites, cfg.block_sites)
        clv_bytes = e * 4 * n_pad
        scaler_bytes = 4 * n_pad
        const_bytes = 3 * cfg.rows * cfg.states * 4
        per_call = dict(
            sites=n_sites, sites_padded=n_pad,
            padding=n_pad - n_sites,
            elements_per_site=e,
            clv_bytes=clv_bytes,
            input_bytes=2 * clv_bytes + const_bytes,
            output_bytes=clv_bytes + scaler_bytes,
            blocks=n_pad // cfg.block_sites,
        )
        per_call["hbm_bytes"] = (per_call["input_bytes"]
                                 + per_call["output_bytes"])
        return dict(per_call=per_call, instances=instances,
                    plf_calls=plf_calls,
                    total_sites=n_sites * plf_calls * instances,
                    total_hbm_bytes=per_call["hbm_bytes"] * instances)

    def describe(self, n_sites: int, plf_calls: int = 1,
                 instances: int = 1) -> str:
        """Reference-style config/geometry report (``host_mem.cpp:45-101``)
        of a workload of ``instances`` node pairs per call."""
        cfg = self.config
        p = self.geometry(n_sites, plf_calls, instances)["per_call"]
        bar = "=" * 68
        rows = [
            bar,
            f"| {'config name':24} | {cfg.to_name():36} |",
            f"| {'backend':24} | {cfg.backend.value:36} |",
            f"| {'device':24} | {str(self.device):36} |",
            f"| {'states x categories':24} | "
            f"{f'{cfg.states} x {cfg.categories}':36} |",
            f"| {'padding unit (sites)':24} | {cfg.block_sites:36} |",
            bar,
            f"| {'alignment sites':24} | {n_sites:36} |",
            f"| {'padded sites':24} | {p['sites_padded']:36} |",
            f"| {'plf calls':24} | {plf_calls:36} |",
            f"| {'instances':24} | {instances:36} |",
            bar,
            f"| {'CLV bytes (each)':24} | {p['clv_bytes']:36} |",
            f"| {'device bytes per call':24} | {p['hbm_bytes']:36} |",
            bar,
        ]
        return "\n".join(rows)

    # -- single call ---------------------------------------------------------

    def plf(self, x1, x2, left, right, ev, wgt=None) -> PLFResult:
        """One PLF call on site-major ``(n, C*S)`` or ``(n, C, S)`` CLVs,
        in the config's CLV storage."""
        return self._plf(x1, x2, left, right, ev, wgt, self.config.dtype)

    def _plf(self, x1, x2, left, right, ev, wgt, dtype: str) -> PLFResult:
        cfg = self.config
        S, C = cfg.states, cfg.categories
        x1 = self._t(x1, torch.float32)
        x2 = self._t(x2, torch.float32)
        n = x1.reshape(-1, C, S).shape[0]
        wgt = (torch.ones(n, dtype=torch.int32, device=self.device)
               if wgt is None else self._t(wgt))
        left, right, ev = (self._t(a, torch.float32)
                           for a in (left, right, ev))
        if cfg.backend is Backend.REFERENCE:
            x3, sv, si = plf_reference(
                x1.cpu().numpy(), x2.cpu().numpy(), left.cpu().numpy(),
                right.cpu().numpy(), ev.cpu().numpy(), wgt.cpu().numpy(),
                states=S, categories=C)
            return PLFResult(self._t(x3), self._t(sv.astype(np.int32)),
                             self._t(si, torch.int64))
        if cfg.backend is Backend.TORCH:
            return PLFResult(*plf_torch(x1, x2, left, right, ev, wgt,
                                        states=S, categories=C))
        return PLFResult(*plf_node_site_major(
            x1, x2, left, right, ev, wgt, states=S, categories=C,
            block_sites=cfg.block_sites,
            variant=cfg.resolved_kernel_variant, dtype=dtype))

    # -- multi-instance -------------------------------------------------------

    def plf_batch(self, x1, x2, left, right, ev, wgt=None) -> PLFResult:
        """Evaluate ``I`` independent node-pairs in one launch.

        Args are batched on a leading instance axis: ``x1/x2``
        ``(I, n, C*S)`` or ``(I, n, C, S)``, ``left/right`` ``(I, C, S, S)``,
        ``ev`` ``(I, S, S)``, ``wgt`` ``(I, n)``.  On ``Backend.KERNEL`` the
        batch is laid out lane-major once, ``(I, S*C, n_pad)``, and runs as
        ONE launch of kernel 1 (or 1m) with an instance axis
        (``ops/plf_node.py::plf_node_batch``), the counterpart of the JAX
        engine's ``vmap`` of the lane-major kernel; ``Backend.TORCH`` and
        ``Backend.REFERENCE`` evaluate the instances in turn.  fp32
        whatever the config's ``dtype``, as the JAX engine's batch is.
        Returns ``x3`` ``(I, n, C, S)``, ``scaler_vector`` ``(I, n)`` and
        ``scaler_increment`` ``(I,)``.
        """
        cfg = self.config
        if cfg.backend is not Backend.KERNEL:
            ni = len(x1)
            outs = [self._plf(x1[i], x2[i], left[i], right[i], ev[i],
                              None if wgt is None else wgt[i], "float32")
                    for i in range(ni)]
            return PLFResult(*(torch.stack([getattr(o, f.name) for o in outs])
                               for f in dataclasses.fields(PLFResult)))
        S, C = cfg.states, cfg.categories
        x1 = self._t(x1, torch.float32)
        ni = x1.shape[0]
        x1 = x1.reshape(ni, -1, C, S)
        n = x1.shape[1]
        x2 = self._t(x2, torch.float32).reshape(ni, n, C, S)
        wgt = (torch.ones((ni, n), dtype=torch.int32, device=self.device)
               if wgt is None else self._t(wgt).reshape(ni, n))

        def lane(x):   # (I, n, C, S) -> (I, S*C, n_pad), one transform
            x = x.permute(0, 3, 2, 1).reshape(ni, S * C, n)
            return L.pad_to_multiple(x, cfg.block_sites).contiguous()

        lm, rm = (self._t(a, torch.float32).reshape(ni, C, S, S)
                  for a in (left, right))
        em = self._t(ev, torch.float32).reshape(ni, S, S)
        lc, rc = (m.permute(0, 2, 1, 3).reshape(ni, S * C, S).contiguous()
                  for m in (lm, rm))
        ec = em.transpose(1, 2).repeat_interleave(C, dim=1).contiguous()
        x3l, sc = plf_node_batch(lane(x1), lane(x2), lc, rc, ec, n,
                                 states=S, categories=C,
                                 variant=cfg.resolved_kernel_variant)
        x3 = x3l.reshape(ni, S, C, -1)[..., :n].permute(0, 3, 2, 1)
        sv = sc[:, :n]
        si = (sv.to(torch.int64) * wgt.to(torch.int64)).sum(dim=-1)
        return PLFResult(x3, sv, si)

    # -- verification (host_mem.cpp:403-442 semantics) -----------------------

    def verify(self, result: PLFResult, x1, x2, left, right, ev, wgt=None,
               max_errors: int = 20, exact: bool = True):
        """Golden-model check; returns ``(ok, n_errors, messages)``.

        ``exact=True`` (the default) applies the reference's bit-exact
        float equality; ``exact=False`` allows 5e-7 relative.
        """
        cfg = self.config
        as_np = lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                           else np.asarray(a))
        x3_ref, sv_ref, si_ref = plf_reference(
            as_np(x1), as_np(x2), as_np(left), as_np(right), as_np(ev),
            None if wgt is None else as_np(wgt),
            states=cfg.states, categories=cfg.categories)
        got = as_np(result.x3).reshape(x3_ref.shape)
        if exact:
            neq = got != x3_ref
        else:
            tol = np.abs(x3_ref) * np.float32(5e-7) + np.float32(1e-37)
            neq = np.abs(got - x3_ref) > tol
        msgs = []
        if neq.any():
            for site, c, a in np.argwhere(neq)[:max_errors]:
                msgs.append(
                    f"ERROR: alignment data wrong at alignment {site}, "
                    f"probability {c * cfg.states + a}, "
                    f"cpu!=device: {x3_ref[site, c, a]}!={got[site, c, a]}")
        n_errors = int(neq.sum())
        si_got = int(as_np(result.scaler_increment))
        if si_got != si_ref:
            msgs.append(f"ERROR: scalerIncrement wrong, cpu!=device: "
                        f"{si_ref}!={si_got}")
            n_errors += 1
        return n_errors == 0, n_errors, msgs



def plf(x1, x2, left, right, ev, wgt=None, config: Optional[PLFConfig] = None,
        device: Union[str, torch.device] = "cuda") -> PLFResult:
    """Functional one-shot PLF with a default engine on ``device``."""
    return PLFEngine(config, device=device).plf(x1, x2, left, right, ev, wgt)
