"""Metrics registry + Prometheus text exposition.

Parity: the reference instruments ~150 series through the ``metrics``
crate facade and exposes them via a Prometheus HTTP exporter
(``config.rs:69-80``, ``agent/metrics.rs:18-108``): gossip/broadcast
counters, sync counters, channel depths, pool timings, per-table row
counts, db/WAL size gauges.  Ours is a small thread-safe registry the
agent exposes at ``GET /metrics`` on the API listener.
"""

from __future__ import annotations

import re
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

LabelKV = Tuple[Tuple[str, str], ...]


def percentile_sorted(s, q: float):
    """Nearest-rank quantile of an ALREADY-SORTED non-empty sequence —
    the one indexing rule shared by exposition, health snapshots, and
    the cluster observer, so the telemetry-vs-ground-truth comparisons
    stay apples-to-apples."""
    return s[min(len(s) - 1, int(len(s) * q))]


class Metrics:
    def __init__(self):
        self._counters: Dict[str, Dict[LabelKV, float]] = defaultdict(dict)
        self._gauges: Dict[str, Dict[LabelKV, float]] = defaultdict(dict)
        self._histos: Dict[str, Dict[LabelKV, List[float]]] = defaultdict(dict)
        # cumulative (count, sum) per histogram series: the quantile ring
        # above trims to its last 1024 samples, so exposition's _count /
        # _sum must NOT be computed from it — they would silently reset
        # at the trim boundary and undercount forever after
        self._histo_agg: Dict[str, Dict[LabelKV, Tuple[int, float]]] = (
            defaultdict(dict)
        )
        self._lock = threading.Lock()

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._counters[name][key] = self._counters[name].get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._gauges[name][key] = value

    def histogram(self, name: str, value: float, **labels) -> None:
        self.histogram_keyed(name, value, tuple(sorted(labels.items())))

    def histogram_keyed(self, name: str, value: float, key: LabelKV) -> None:
        """Hot-path histogram insert with a caller-PRECOMPUTED label
        key (skips kwargs packing + sort — provenance records one of
        these per version on the ingest path)."""
        self.histogram_keyed_many(name, ((key, value),))

    def histogram_keyed_many(
        self, name: str, pairs: Iterable[Tuple[LabelKV, float]]
    ) -> None:
        """Batched keyed inserts under ONE lock hold — the ingest
        pipeline records a whole apply batch's provenance lags at
        once (PRs 3-5 batching discipline applied to telemetry)."""
        with self._lock:
            histos = self._histos[name]
            agg = self._histo_agg[name]
            for key, value in pairs:
                buf = histos.setdefault(key, [])
                buf.append(value)
                if len(buf) >= 1280:
                    # block trim: deleting ONE sample per insert once
                    # past the window is an O(window) memmove per
                    # observation — a measurable ingest tax; trimming
                    # 256 at a time amortizes it to O(1) (the ring
                    # holds 1024..1279 samples; quantiles read
                    # whatever is present)
                    del buf[: len(buf) - 1024]
                n, s = agg.get(key, (0, 0.0))
                agg[key] = (n + 1, s + value)

    def timed(self, name: str, **labels):
        return _Timer(self, name, labels)

    def get_counter(self, name: str, **labels) -> float:
        """Current value of one counter series (0.0 if never incremented)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._counters.get(name, {}).get(key, 0.0)

    def get_counter_sum(self, name: str) -> float:
        """Sum of a counter across ALL its label variants."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def histogram_samples(self, name: str) -> Dict[LabelKV, List[float]]:
        """Snapshot of one histogram's windowed sample rings per label
        variant (the last ~1024-1279 observations each).  Harness surface:
        the in-process ClusterObserver computes exact cross-node
        percentiles from raw samples where exposition only carries
        per-node quantiles."""
        with self._lock:
            return {k: list(v) for k, v in self._histos.get(name, {}).items()}

    def histogram_stats(self, name: str, **labels) -> Tuple[int, float]:
        """Cumulative ``(count, sum)`` of one histogram series — never
        resets, unlike the windowed quantile ring."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._histo_agg.get(name, {}).get(key, (0, 0.0))

    @staticmethod
    def _series_key(name: str, key: LabelKV) -> str:
        """Flat ``name{k=v,...}`` identity for one labeled series — the
        flight recorder's snapshot/delta key (JSON-safe, stable)."""
        if not key:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"

    def snapshot_state(self) -> Tuple[Dict[str, float], Dict[str, float],
                                      Dict[str, Tuple[float, float]]]:
        """One-lock flight snapshot (``agent/recorder.py``): every
        counter value, every gauge, and each histogram series' windowed
        (p50, p99) — flattened to ``name{labels}`` keys.  One lock hold
        per snapshot interval."""
        with self._lock:
            counters = {
                self._series_key(name, key): v
                for name, series in self._counters.items()
                for key, v in series.items()
            }
            gauges = {
                self._series_key(name, key): v
                for name, series in self._gauges.items()
                for key, v in series.items()
            }
            quantiles = {}
            for name, series in self._histos.items():
                for key, buf in series.items():
                    if not buf:
                        continue
                    s = sorted(buf)
                    quantiles[self._series_key(name, key)] = (
                        percentile_sorted(s, 0.5),
                        percentile_sorted(s, 0.99),
                    )
        return counters, gauges, quantiles

    # -- exposition ------------------------------------------------------

    def render(self, extra_gauges: Iterable[Tuple[str, float, dict]] = ()) -> str:
        out: List[str] = []

        def esc(val) -> str:
            # Prometheus label-value escaping: backslash, quote, newline
            return (
                str(val)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def fmt(name: str, key: LabelKV, v: float, suffix: str = "") -> str:
            if key:
                lbl = ",".join(f'{k}="{esc(val)}"' for k, val in key)
                return f"{name}{suffix}{{{lbl}}} {v}"
            return f"{name}{suffix} {v}"

        # group extras by name up front and MERGE them into the gauge
        # registry families: a scrape-time gauge sharing a name with a
        # registered one (e.g. corro_members_ring0) must render under a
        # single "# TYPE" line — strict parsers reject a repeated TYPE
        grouped: Dict[str, Dict[LabelKV, float]] = {}
        for name, v, labels in extra_gauges:
            grouped.setdefault(name, {})[tuple(sorted(labels.items()))] = v
        with self._lock:
            for name, series in sorted(self._counters.items()):
                out.append(f"# TYPE {name} counter")
                for key, v in series.items():
                    out.append(fmt(name, key, v))
            gauges: Dict[str, Dict[LabelKV, float]] = {
                name: dict(series) for name, series in self._gauges.items()
            }
            for name, series in grouped.items():
                # scrape-time values win: they are current, the
                # registered value is the last push
                gauges.setdefault(name, {}).update(series)
            for name, series in sorted(gauges.items()):
                out.append(f"# TYPE {name} gauge")
                for key, v in series.items():
                    out.append(fmt(name, key, v))
            for name, series in sorted(self._histos.items()):
                out.append(f"# TYPE {name} summary")
                for key, buf in series.items():
                    if not buf:
                        continue
                    s = sorted(buf)
                    out.append(fmt(
                        name, key + (("quantile", "0.5"),),
                        percentile_sorted(s, 0.5),
                    ))
                    out.append(fmt(
                        name, key + (("quantile", "0.99"),),
                        percentile_sorted(s, 0.99),
                    ))
                    # quantiles come from the windowed ring; count/sum
                    # are the CUMULATIVE aggregates (a summary's _count
                    # must be monotone — the ring trims at 1024)
                    n, total = self._histo_agg[name].get(key, (0, 0.0))
                    out.append(fmt(name, key, float(n), "_count"))
                    out.append(fmt(name, key, float(total), "_sum"))
        return "\n".join(out) + "\n"


# -- strict exposition parsing ----------------------------------------
#
# The consumer half of the exposition contract: ClusterObserver scrapes
# every node's /metrics text through this parser, and the hostile-input
# exposition tests assert adversarial table names / label values still
# produce text it accepts.  Deliberately STRICT — any malformed line is
# an error, not a skip — so an escaping regression in render() fails
# loudly instead of silently corrupting a scrape.

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_TYPES = frozenset({"counter", "gauge", "summary", "histogram", "untyped"})


class ExpositionError(ValueError):
    """Prometheus text exposition violating the format."""


def _parse_labels(body: str) -> Dict[str, str]:
    """Parse the inside of ``{...}`` strictly: ``name="value"`` pairs,
    comma-separated, values escaped with ``\\\\``, ``\\"``, ``\\n``
    only."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0:
            raise ExpositionError(f"label without '=': {body[i:]!r}")
        name = body[i:j]
        if not _NAME_RE.match(name):
            raise ExpositionError(f"bad label name {name!r}")
        if j + 1 >= n or body[j + 1] != '"':
            raise ExpositionError(f"unquoted label value after {name!r}")
        i = j + 2
        out: List[str] = []
        while True:
            if i >= n:
                raise ExpositionError(f"unterminated label value for {name!r}")
            c = body[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ExpositionError("dangling escape")
                e = body[i + 1]
                if e == "\\":
                    out.append("\\")
                elif e == '"':
                    out.append('"')
                elif e == "n":
                    out.append("\n")
                else:
                    raise ExpositionError(f"bad escape \\{e}")
                i += 2
            elif c == '"':
                i += 1
                break
            elif c == "\n":
                raise ExpositionError("raw newline in label value")
            else:
                out.append(c)
                i += 1
        labels[name] = "".join(out)
        if i < n:
            if body[i] != ",":
                raise ExpositionError(f"junk after label value: {body[i:]!r}")
            i += 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Strictly parse Prometheus text exposition into
    ``{family: {"type": str, "samples": [(name, labels, value), ...]}}``.

    Summary ``_count``/``_sum`` suffix lines file under their base
    family.  Raises :class:`ExpositionError` on any malformed line,
    repeated ``# TYPE`` for one family, or a sample without a
    preceding TYPE declaration."""
    families: Dict[str, dict] = {}
    for lineno, line in enumerate(text.split("\n"), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 2 or parts[1] not in ("TYPE", "HELP"):
                raise ExpositionError(f"line {lineno}: bad comment {line!r}")
            if parts[1] == "HELP":
                continue
            if len(parts) != 4:
                raise ExpositionError(f"line {lineno}: bad TYPE line {line!r}")
            _, _, fam, typ = parts
            if not _NAME_RE.match(fam):
                raise ExpositionError(f"line {lineno}: bad family name {fam!r}")
            if typ not in _TYPES:
                raise ExpositionError(f"line {lineno}: unknown type {typ!r}")
            if fam in families:
                raise ExpositionError(
                    f"line {lineno}: repeated TYPE for {fam!r}"
                )
            families[fam] = {"type": typ, "samples": []}
            continue
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ExpositionError(f"line {lineno}: unbalanced braces")
            name = line[:brace]
            labels = _parse_labels(line[brace + 1 : close])
            rest = line[close + 1 :]
        else:
            sp = line.find(" ")
            if sp < 0:
                raise ExpositionError(f"line {lineno}: no value in {line!r}")
            name = line[:sp]
            labels = {}
            rest = line[sp:]
        if not _NAME_RE.match(name):
            raise ExpositionError(f"line {lineno}: bad metric name {name!r}")
        if not rest.startswith(" ") or " " in rest[1:].strip():
            raise ExpositionError(f"line {lineno}: bad value field {rest!r}")
        try:
            value = float(rest.strip())
        except ValueError as e:
            raise ExpositionError(f"line {lineno}: bad value: {e}") from None
        fam = name
        for suffix in ("_count", "_sum"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in families and families[base]["type"] in (
                "summary", "histogram",
            ):
                fam = base
                break
        if fam not in families:
            raise ExpositionError(
                f"line {lineno}: sample {name!r} without a TYPE declaration"
            )
        families[fam]["samples"].append((name, labels, value))
    return families


class _Timer:
    def __init__(self, metrics: Metrics, name: str, labels: dict):
        self.metrics = metrics
        self.name = name
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.histogram(
            self.name, time.perf_counter() - self.t0, **self.labels
        )
        return False
