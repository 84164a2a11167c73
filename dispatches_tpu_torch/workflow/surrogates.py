"""NN market surrogates: revenue + dispatch-frequency MLPs (counterpart
of ``dispatches_tpu/workflow/surrogates.py``).

Labels are either swept-run revenues or per-run cluster-frequency
vectors ``[ws0, f_1..f_k, ws1]`` built by predicting each day-slice
against the trained k-means centroids; the surrogate is an MLP with
sigmoid hidden layers trained with Adam on MSE for 500 epochs on
standardized inputs/outputs (the reference's Keras recipe), with the
reference's scaling-metadata json (xm/xstd/xmin/xmax + label mean/std).

The MLP is :class:`MLP`, an ``nn.Module`` in float64; its weights cross
to and from the JAX package's layout ``[{"W": (fan_in, fan_out), "b":
(fan_out,)}, ...]`` through :meth:`MLP.from_params` / :meth:`MLP.to_params`,
and the shipped ``.npz`` artifacts load into it directly.  Training runs
on ``device`` (``cuda`` unless the caller passes ``device="cpu"``); the
initial weights are Glorot-uniform draws from a CPU ``torch.Generator``
seeded with ``seed`` (the JAX package draws them with ``jax.random``),
and the optimizer is ``torch.optim.Adam`` with optax's defaults.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.workflow.clustering import TimeSeriesClustering, slice_days

__all__ = ["MLP", "mlp_apply", "TrainNNSurrogates", "pretrained_surrogates",
           "load_pretrained_surrogate"]

_NOT_PORTED_MESH = ("data-parallel surrogate training over a device mesh "
                    "(mesh=) is not ported yet (ROADMAP.md queue 1, item 7: "
                    "the execution layer's mesh)")


class MLP(nn.Module):
    """Sigmoid hidden layers, linear output, float64 (the reference's
    Keras surrogate architecture)."""

    def __init__(self, sizes: Sequence[int], device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1], dtype=torch.float64, device=device)
            for i in range(len(sizes) - 1))

    @classmethod
    def from_params(cls, params: List[Dict], device=None) -> "MLP":
        """An MLP holding the JAX-layout weights ``params`` (W is
        (fan_in, fan_out); any float dtype, held as float64)."""
        sizes = [np.shape(params[0]["W"])[0]] + [np.shape(p["W"])[1] for p in params]
        mlp = cls(sizes, device=device)
        with torch.no_grad():
            for layer, p in zip(mlp.layers, params):
                W = torch.tensor(np.asarray(p["W"]), dtype=torch.float64)
                b = torch.tensor(np.asarray(p["b"]), dtype=torch.float64)
                layer.weight.copy_(W.T)
                layer.bias.copy_(b)
        return mlp

    def to_params(self) -> List[Dict[str, np.ndarray]]:
        """The weights in the JAX package's layout, as host numpy."""
        return [{"W": layer.weight.detach().T.cpu().numpy(),
                 "b": layer.bias.detach().cpu().numpy()} for layer in self.layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.sigmoid(h @ layer.weight.T + layer.bias)
        last = self.layers[-1]
        return h @ last.weight.T + last.bias


def mlp_apply(params, x, device=None) -> torch.Tensor:
    """The MLP (an :class:`MLP`, or weights in the JAX layout) on ``x``,
    on the MLP's device.  JAX-layout weights run on the device of ``x``
    when it is a tensor, else on ``device`` (``cuda`` unless given)."""
    if isinstance(params, MLP):
        mlp = params
    else:
        dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
        mlp = MLP.from_params(params, device=dev)
    return mlp(torch.as_tensor(x, dtype=torch.float64, device=mlp.layers[0].weight.device))


def _init_mlp(sizes: Sequence[int], seed: int) -> List[Dict[str, np.ndarray]]:
    """Glorot-uniform weights (the Keras Dense default) and zero biases,
    drawn from a CPU generator seeded with ``seed``, in the JAX layout."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    params = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float64)
        params.append({"W": (-lim + 2.0 * lim * u).numpy(),
                       "b": np.zeros(fan_out)})
    return params


def _train_mlp(x, y, sizes, epochs=500, seed=0, learning_rate=1e-3,
               batch_size=None, mesh=None, device=None):
    """Adam training of an MLP (the reference's 500-epoch Keras fit) on
    ``device`` (``cuda`` unless given).  ``batch_size`` enables shuffled
    minibatch epochs (numpy ``default_rng(seed)`` permutations, the tail
    batch padded from the permutation's head, as in the JAX package)
    instead of full-batch steps.  Returns (MLP, last loss)."""
    if mesh is not None:
        raise NotImplementedError(_NOT_PORTED_MESH)
    dev = resolve_device(device)
    mlp = MLP.from_params(_init_mlp(sizes, seed), device=dev)
    opt = torch.optim.Adam(mlp.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)

    def step(xb, yb):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((mlp(xb) - yb) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    loss = torch.tensor(float("inf"))
    if batch_size is None or batch_size >= n:
        for _ in range(epochs):
            loss = step(xt, yt)
        return mlp, float(loss)

    bs = int(batch_size)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(0, n, bs):
            idx = perm[s:s + bs]
            if len(idx) < bs:  # pad the tail to the full batch shape
                idx = np.concatenate([idx, perm[: bs - len(idx)]])
            it = torch.as_tensor(idx, device=dev)
            loss = step(xt[it], yt[it])
    return mlp, float(loss)


def _train_test_split(x, y, test_size, seed):
    n = len(x)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_size))) if n > 1 else 0
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


class TrainNNSurrogates:
    def __init__(self, simulation_data, data_file, filter_opt=True, device=None):
        self.simulation_data = simulation_data
        self.data_file = str(data_file)
        self.filter_opt = filter_opt
        self.device = device
        self._time_length = 24
        self.model_type = None
        self._model_params = None
        self.clustering_model = None
        self.num_clusters = None

    @classmethod
    def from_sweep(cls, store, filter_opt=False, device=None) -> "TrainNNSurrogates":
        """Trainer wired to a finished ``sweep.ResultStore``: design
        coordinates become the input table, sweep objectives the revenue
        labels (quarantined points pre-filtered).  Use with
        :meth:`train_NN_revenue`, or ``sweep.train_revenue_surrogate``."""
        from dispatches_tpu_torch.sweep.surrogate import SweepData

        data = SweepData(store)
        return cls(data, data_file=str(data.store.path), filter_opt=filter_opt,
                   device=device)

    # -- clustering-model consumption ---------------------------------

    def _read_clustering_model(self, clustering_model_path):
        model = TimeSeriesClustering.load_clustering_model(clustering_model_path)
        self.clustering_model = model
        self.num_clusters = model["n_clusters"]
        return model

    def _predict_clusters(self, days: np.ndarray) -> np.ndarray:
        centers = self.clustering_model["cluster_centers_"]
        d2 = (
            np.sum(days * days, 1)[:, None]
            - 2.0 * days @ centers.T
            + np.sum(centers * centers, 1)[None, :]
        )
        return np.argmin(d2, axis=1)

    # -- label generation ---------------------------------------------

    def _generate_label_data(self) -> Dict[int, List[float]]:
        scaled = self.simulation_data._scale_data()
        out = {}
        for idx, year in scaled.items():
            day_num = len(year) // self._time_length
            days, zero_day, full_day, _ = slice_days(
                year, self._time_length, self.filter_opt
            )
            counts = np.zeros(self.num_clusters)
            if days:
                for j in self._predict_clusters(np.asarray(days)):
                    counts[j] += 1
            if self.filter_opt:
                ws = [zero_day / day_num]
                ws.extend((counts / day_num).tolist())
                ws.append(full_day / day_num)
            else:
                ws = (counts / day_num).tolist()
            out[idx] = ws
        return out

    def _transform_dict_to_array(self):
        if self.model_type == "frequency":
            y_dict = self._generate_label_data()
        else:
            y_dict = self.simulation_data.read_rev_data(self.data_file)
        idxs = list(self.simulation_data._dispatch_dict.keys())
        x = np.array([self.simulation_data._input_data_dict[i] for i in idxs])
        y = np.array([y_dict[i] for i in idxs])
        if y.ndim == 1:
            y = y[:, None]
        return x, y

    # -- training -------------------------------------------------------

    def _train(self, NN_size, split_seed, epochs, batch_size=None, mesh=None):
        x, y = self._transform_dict_to_array()
        x_train, x_test, y_train, y_test = _train_test_split(
            x, y, test_size=0.2, seed=split_seed
        )
        xm, xstd = np.mean(x_train, 0), np.std(x_train, 0)
        ym, ystd = np.mean(y_train, 0), np.std(y_train, 0)
        xstd = np.where(xstd == 0, 1.0, xstd)
        ystd = np.where(ystd == 0, 1.0, ystd)
        xs, ys = (x_train - xm) / xstd, (y_train - ym) / ystd

        mlp, train_loss = _train_mlp(xs, ys, NN_size, epochs=epochs,
                                     batch_size=batch_size, mesh=mesh,
                                     device=self.device)
        params = mlp.to_params()

        # R2 on the held-out split
        R2 = None
        if len(x_test):
            with torch.no_grad():
                pred = mlp_apply(mlp, (x_test - xm) / xstd).cpu().numpy() * ystd + ym
            ss_tot = np.sum((y_test - ym) ** 2, axis=0)
            ss_res = np.sum((y_test - pred) ** 2, axis=0)
            R2 = (1.0 - ss_res / np.where(ss_tot == 0, 1.0, ss_tot)).tolist()

        self._model_params = {
            "xm_inputs": xm.tolist(),
            "xstd_inputs": xstd.tolist(),
            "xmin": np.min(xs, 0).tolist(),
            "xmax": np.max(xs, 0).tolist(),
            "y_mean": ym.tolist(),
            "y_std": ystd.tolist(),
            "R2": R2,
            "train_loss": train_loss,
        }
        return params

    def train_NN_frequency(self, NN_size, epochs=500, batch_size=None, mesh=None):
        self.model_type = "frequency"
        self._read_clustering_model(self.data_file)
        return self._train(NN_size, split_seed=0, epochs=epochs,
                           batch_size=batch_size, mesh=mesh)

    def train_NN_revenue(self, NN_size, epochs=500, batch_size=None, mesh=None):
        self.model_type = "revenue"
        return self._train(NN_size, split_seed=42, epochs=epochs,
                           batch_size=batch_size, mesh=mesh)

    # -- persistence ----------------------------------------------------

    def save_model(self, params, NN_model_path, NN_param_path):
        """Checkpoint = npz of layer weights (W0, b0, ...) + the
        scaling-metadata json."""
        flat = {}
        layers = params.to_params() if isinstance(params, MLP) else params
        for i, layer in enumerate(layers):
            flat[f"W{i}"] = np.asarray(layer["W"])
            flat[f"b{i}"] = np.asarray(layer["b"])
        np.savez(NN_model_path, **flat)
        with open(NN_param_path, "w") as f:
            json.dump(self._model_params, f)

    @staticmethod
    def load_model(NN_model_path, NN_param_path=None):
        """(weights in the JAX layout as numpy, scaling dict or None)."""
        data = np.load(NN_model_path)
        n_layers = sum(1 for k in data.files if k.startswith("W"))
        params = [{"W": data[f"W{i}"], "b": data[f"b{i}"]} for i in range(n_layers)]
        scaling = None
        if NN_param_path is not None:
            with open(NN_param_path) as f:
                scaling = json.load(f)
        return params, scaling

    @staticmethod
    def predict(params, scaling, x, device=None):
        """Unscaled inputs -> unscaled outputs (numpy), the MLP run on
        ``device`` (``cuda`` unless given)."""
        dev = resolve_device(device)
        x = (np.asarray(x) - np.asarray(scaling["xm_inputs"])) / np.asarray(
            scaling["xstd_inputs"]
        )
        mlp = params.to(dev) if isinstance(params, MLP) else MLP.from_params(params, device=dev)
        with torch.no_grad():
            out = mlp_apply(mlp, torch.as_tensor(x, dtype=torch.float64, device=dev)).cpu().numpy()
        # frequency-surrogate jsons name the label moments ws_mean/ws_std;
        # revenue ones y_mean/y_std
        ystd = scaling.get("y_std", scaling.get("ws_std"))
        ym = scaling.get("y_mean", scaling.get("ws_mean"))
        if ystd is None or ym is None:
            raise KeyError(
                "scaling json must carry label moments as y_mean/y_std "
                "or ws_mean/ws_std; got keys " + str(sorted(scaling))
            )
        return out * np.asarray(ystd) + np.asarray(ym)


# ---------------------------------------------------------------------
# shipped pre-trained artifacts (the reference's six trained Keras
# surrogates, weight data layer by layer, scaling jsons verbatim)
# ---------------------------------------------------------------------

_ARTIFACTS_DIR = Path(__file__).resolve().parent / "artifacts"


def pretrained_surrogates() -> Dict[str, dict]:
    """Manifest of the shipped pre-trained market surrogates (revenue +
    dispatch-frequency for the RE/NE/FE case studies).  ``FE_revenue``
    is flagged ``upstream_nan_weights``: the reference's own SavedModel
    carries an all-NaN output layer, so it loads but cannot predict."""
    with open(_ARTIFACTS_DIR / "manifest.json") as f:
        return json.load(f)


def load_pretrained_surrogate(name: str):
    """Load a shipped artifact by manifest name (e.g. ``"RE_revenue"``)
    -> ``(params, scaling)`` ready for :meth:`TrainNNSurrogates.predict`."""
    manifest = pretrained_surrogates()
    if name not in manifest:
        raise KeyError(
            f"unknown pretrained surrogate {name!r}; "
            f"available: {sorted(manifest)}"
        )
    entry = manifest[name]
    case_dir = _ARTIFACTS_DIR / entry["case"]
    return TrainNNSurrogates.load_model(
        case_dir / f"{name}.npz", case_dir / entry["params_json"]
    )
