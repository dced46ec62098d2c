"""The traced requests' device kernels split by the layer that launched
them: the spans the benchmark puts around each request (`bench.request`),
the model (`bench.model`) and its encoder (`bench.encoder`).

- prep: launched in a request before its model span (device prep),
- encoder: inside the encoder span,
- decoders: inside the model span but not the encoder's (context module,
  decoders, scene head),
- post: in the request after the model span (postprocessing).
"""

from __future__ import annotations

from typing import Dict, List


def request_parts(trace) -> Dict[str, List[Dict]]:
    parts = {"prep": [], "encoder": [], "decoders": [], "post": []}
    models = trace.spans("bench.model")
    encoders = trace.spans("bench.encoder")
    enc = {id(k) for k in trace.launched_in(encoders)}
    for r in trace.spans("bench.request"):
        a, b = r["ts"], r["ts"] + r["dur"]
        (m,) = [m for m in models if a <= m["ts"] <= b]
        ma, mb = m["ts"], m["ts"] + m["dur"]
        for k in trace.launched_in([r]):
            t = k["launch_ts"]
            if t < ma:
                parts["prep"].append(k)
            elif t > mb:
                parts["post"].append(k)
            elif id(k) in enc:
                parts["encoder"].append(k)
            else:
                parts["decoders"].append(k)
    return parts
