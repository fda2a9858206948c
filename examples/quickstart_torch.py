"""Quickstart of the PyTorch/CUDA port: profile a graph, let the paper's
specialization model pick the system configuration, run PageRank under
it on the card, verify against the numpy oracle.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.algorithms import pagerank  # noqa: E402
from repro_torch.algorithms.reference import pagerank_np  # noqa: E402
from repro_torch.core import run, specialize  # noqa: E402
from repro_torch.core.taxonomy import profile_graph  # noqa: E402
from repro_torch.graph import powerlaw_graph  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="default: the CUDA card")
args = ap.parse_args()

# 1. an input graph (synthetic power-law, ~8k vertices)
graph = powerlaw_graph(8192, 60000, alpha=1.2, max_degree=800,
                       locality=0.3, seed=0)

# 2. taxonomy: Volume (Eq.1), Reuse (Eq.6), Imbalance (Eq.7)
profile = profile_graph(graph)
print(f"profile: volume={profile.volume_kb:.1f}KB({profile.volume_class}) "
      f"reuse={profile.reuse:.3f}({profile.reuse_class}) "
      f"imbalance={profile.imbalance:.3f}({profile.imbalance_class})")

# 3. the decision tree (paper Fig. 4) picks update-prop/coherence/consistency
program = pagerank()
config = specialize(program.properties, profile)
print(f"specialized config: {config.name}  "
      f"({config.prop.name} / {config.coherence.name} / "
      f"{config.consistency.name})")

# 4. execute under that configuration, on the card unless --device says
result = run(program, graph, config, device=args.device)
print(f"pagerank converged={result.converged} in {result.iterations} "
      f"iterations, {result.seconds*1e3:.1f} ms on "
      f"{result.state['rank'].device}")

# 5. verify against the numpy oracle
err = np.abs(result.state["rank"].cpu().numpy() - pagerank_np(graph)).max()
print(f"max |err| vs oracle: {err:.2e}")
assert err < 1e-4
