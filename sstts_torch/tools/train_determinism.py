"""Where two train steps from one state part ways on the card.

    python3 sstts_torch/tools/train_determinism.py     # from the repo root, on the H100

At the default `Config()` widths on the synthetic corpus (b=32, 32 rows of
bucket 1 from the resident corpus), two states from one init run 4 cached
steps each, side by side, with cuDNN's default algorithms and then its
deterministic ones; after each step it prints the metrics' largest
difference and the parameters whose gradients differ.  Then the same 4
steps twice under PyTorch's default algorithms and under
`torch.use_deterministic_algorithms(True, warn_only=True)`, and
`nn.Embedding`'s backward alone, three times, at the batch's 4096 indices
and at 2048 (CUDA takes another path at 3072 and fewer).  It imports
`chip_smoke` from the current directory for the corpus's configuration.
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from sstts_torch import train as tr
    from sstts_torch.ops import build
    from sstts_torch.tools import card_line

    if not torch.cuda.is_available():
        print("train_determinism: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    cfg = cs.corpus_config()
    (corpus, counts), _ = tr.build_device_corpus(cfg, tr.load_corpus(cfg)[0], device=dev)
    rows = corpus[1]
    idxs = (np.arange(128, dtype=np.int32) % counts[1]).reshape(4, 32)
    valid = np.ones(32, np.float32)
    step = tr.make_cached_train_step(cfg)

    cudnn = torch.backends.cudnn
    for deterministic_cudnn in (False, True):
        cudnn.deterministic = deterministic_cudnn
        print(f"cuDNN deterministic: {deterministic_cudnn}", flush=True)
        a, b = (tr.create_state(cfg, seed=0, device=dev) for _ in range(2))
        names = [n for n, _ in a.model.named_parameters()]
        for i in range(4):
            ma, mb = step(a, rows, idxs[i], valid), step(b, rows, idxs[i], valid)
            grads = [(n, float((pa.grad - pb.grad).abs().max()))
                     for n, pa, pb in zip(names, a.model.parameters(), b.model.parameters())]
            differ = [(n, d) for n, d in grads if d]
            params = sum(not torch.equal(pa, pb)
                         for pa, pb in zip(a.model.parameters(), b.model.parameters()))
            print(f"  step {i + 1}: metrics {max(float((ma[k] - mb[k]).abs()) for k in ma):.3e} "
                  f"apart; {len(differ)} of {len(names)} gradients differ {differ[:3]}; "
                  f"{params} parameters differ", flush=True)
    cudnn.deterministic = False

    def twice():
        out = []
        for _ in range(2):
            st = tr.create_state(cfg, seed=0, device=dev)
            ms = [step(st, rows, idxs[i], valid) for i in range(4)]
            out.append(({k: torch.stack([m[k] for m in ms]) for k in ms[0]},
                        [p.detach().clone() for p in st.model.parameters()]))
        (m0, p0), (m1, p1) = out
        return (max(float((m0[k] - m1[k]).abs().max()) for k in m0),
                max(float((x - y).abs().max()) for x, y in zip(p0, p1)))

    print(f"4 steps twice, default algorithms: metrics, parameters apart {twice()}", flush=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            print(f"4 steps twice, deterministic algorithms: {twice()}; warnings "
                  f"{sorted({str(w.message)[:120] for w in caught})}", flush=True)
        finally:
            torch.use_deterministic_algorithms(False)

    ids = rows["char_ids"][:32].long()
    emb = torch.nn.Embedding(int(ids.max()) + 1, cfg.arch.embedding_dim).to(dev)
    grad_out = torch.randn(*ids.shape, cfg.arch.embedding_dim, device=dev)
    for cols in (ids.shape[1], ids.shape[1] // 2):
        grads = []
        for _ in range(3):
            emb.zero_grad()
            emb(ids[:, :cols]).backward(grad_out[:, :cols])
            grads.append(emb.weight.grad.clone())
        print(f"nn.Embedding backward at {ids[:, :cols].numel()} indices, 3 runs: largest "
              f"difference from the first {[float((grads[0] - g).abs().max()) for g in grads[1:]]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
