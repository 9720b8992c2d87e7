"""The control of the check that decides ``correct``: the plain reference
put in the program's place, computed one precision below what the
configuration states, must come out as not correct.

    python3 torr_bench/control.py --workload edge-prefix-served --seeds 1,2,3

For each seed it makes the cell's inputs, serves every stream's windows
through the reference in the lower precision (the encode's product in
TF32 where the configuration states float32 with TF32 off; the scores,
the reasoned rows and the reasoner's margins in bfloat16 where it states
float32), and hands those outputs to the same check a run's outputs get,
at the cell's own size and with as many windows a stream as a run of
``run_seconds`` serves. One JSON line a seed: the numbers compared, their
limits and whether the control was caught. The program is not imported.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tbench import check as chk  # noqa: E402
from tbench import inputs as inp_mod  # noqa: E402
from tbench import manifest  # noqa: E402
from tbench import reference as ref  # noqa: E402
from tbench.serving import Window  # noqa: E402


def control_outputs(inp, tc: dict, n_windows: int, device):
    """Every stream's first ``n_windows`` windows served by the reference
    in the lower precision: (windows per stream, final cache)."""
    S, Wn, N = inp.valid.shape
    dev = torch.device(device)
    feats = inp.feats.reshape(S * Wn * N, -1)
    words = ref.encode(feats, inp.R, tf32=True).reshape(S * Wn, N, -1)
    origin = np.repeat(np.arange(S), Wn)
    served = [ref.Served(content=s * Wn + np.arange(n_windows) % Wn,
                         valid=inp.valid[s, np.arange(n_windows) % Wn],
                         qd=np.zeros(n_windows, np.int64))
              for s in range(S)]
    low = torch.bfloat16
    rep = ref.replay(tc, inp.codes.to(dev), words.to(dev), served, origin,
                     dtype=low)
    task_w = inp.task_w.to(dev)
    windows = []
    for s in range(S):
        ws = []
        for k in range(n_windows):
            j = k % Wn
            v = inp.valid[s, j]
            ptr = rep.out_ptr[s][k]
            rows = ref.reasoned(rep, ptr, task_w, low)
            best = torch.argmax(rows, 1).cpu().numpy().astype(np.int32)
            best[~v] = 0
            w = Window(stream=s, seq=k, j=j)
            w.words = words[s * Wn + j]
            w.scores = rows.cpu().numpy()[v]
            w.best = best
            w.path = rep.path[s][k].astype(np.int32)
            w.d_count = rep.d_count[s][k]
            w.rho = rep.rho[s][k]
            w.qd, w.banks = 0, int(rep.banks[s][k])
            w.n_valid, w.high = int(v.sum()), bool(rep.high[s][k])
            w.ok = True
            ws.append(w)
        windows.append(ws)
    c = dict(rep.cache)
    K = tc["K"]
    c["out"] = ref.reasoned(rep, c.pop("out_ptr").reshape(-1), task_w,
                            low).reshape(S, K, -1).cpu().numpy()
    return windows, c


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--windows-per-stream", type=int, default=0,
                    help="0: as many as a run of run_seconds serves")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the control runs on the card", file=sys.stderr)
        return 2
    man = manifest.load()
    w = manifest.cell(man, args.workload)
    cfgf, traffic = w["config_file"], w["traffic_file"]
    tc, dep = cfgf["torr"], cfgf["deployment"]
    n = args.windows_per_stream or int(
        traffic["control_windows_per_s"]
        * (traffic["warmup_s"] + man["run_seconds"]))
    S = traffic["streams_per_card"] * dep["cards"]
    n_max = traffic["n_max"]
    n_max = tc[n_max] if isinstance(n_max, str) else n_max
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        inp = inp_mod.make_inputs(tc, S, traffic["windows_per_stream"],
                                  n_max, seed, "cuda:0")
        windows, cache = control_outputs(inp, tc, n, "cuda:0")
        numbers = chk.check(inp, windows, cache, tc, seed, "cuda:0")
        caught, shown = chk.verdict(numbers, cfgf["limits"])
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "windows_per_stream": n, "streams": S,
            "numbers": {k: v["value"] for k, v in shown.items()},
            "limits": {k: v["limit"] for k, v in shown.items()},
            "enc_differ": numbers.get("enc_differ"),
            "enc_bits": numbers.get("enc_bits"),
            "control_caught": not caught,
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
