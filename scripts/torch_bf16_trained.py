"""The bf16 scoring mode's kernels on trained weights: how far each is from
its plain version, and how far the plain version on the card is from the
same plain version on the CPU (two float32 summation orders), on one card.

    python scripts/torch_bf16_trained.py [--seed 0]

Writes ``chip_smoke.py``'s MNIST, CIFAR-10 and IMDB fixtures from ``--seed``
into a temp ``TIP_DATA_DIR``, trains run 0 of each family one epoch
(``chip_smoke.registry_spec``, cuDNN deterministic, as ``chip_smoke.py``
does), and prints one JSON line per family: for B1 and B3 in bf16 over the
first 10,000 training images, and for B4 in bf16 on the bf16 q/k/v of an
IMDB bf16 forward over 8,192 nominal rows, the max and mean |difference|,
the elements (and images) above 1e-4 and above 1e-3, for the kernel
against its plain version on the card, the plain version on the card
against it on the CPU, and the kernel against the CPU's plain version;
then the card's name and power limit. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float().cpu() - b.float().cpu()).abs()
    out = {"max": float(d.max()), "mean": float(d.mean()), "above_1e-4": int((d > 1e-4).sum()),
           "above_1e-3": int((d > 1e-3).sum())}
    if d.dim() == 2:
        out["images_above_1e-4"] = int((d > 1e-4).any(dim=1).sum())
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from simple_tip_tpu_torch import _build
    from simple_tip_tpu_torch.bridge import params_from_jax
    from simple_tip_tpu_torch.casestudies import base
    from simple_tip_tpu_torch.casestudies.base import CaseStudy
    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.models.predict import to_device
    from simple_tip_tpu_torch.ops import flash_attention as fa
    from simple_tip_tpu_torch.ops import fused_forward as ff

    dev = resolve(None)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _build.library()
    root = tempfile.mkdtemp(prefix="tip_bf16_trained_")
    os.environ["TIP_DATA_DIR"] = os.path.join(root, "datasets")
    os.environ["TIP_ASSETS"] = os.path.join(root, "assets")
    cs.IMAGE_FIXTURES = {k: v for k, v in cs.IMAGE_FIXTURES.items() if k != "fmnist"}
    cs.write_fixtures(os.environ["TIP_DATA_DIR"], args.seed)
    for family in ("mnist", "cifar10", "imdb"):
        cs.clear_loaders()
        base.CASE_STUDIES[family] = cs.registry_spec(family)
        study = CaseStudy(base.CASE_STUDIES[family])
        (x_tr, _), (x_te, _), _ = study.spec.loader(device=dev)
        study.train([0], device=dev)
        params = params_from_jax(study.load_params(0))
        with torch.no_grad():
            if family == "imdb":
                net = cs._bf16_net("imdb", params, dev)
                attn = net.block.attention
                emb = net.embedding(to_device(x_te[:8192], dev))
                b, t, _ = emb.shape
                q, k, v = (F.linear(emb, p.weight.bfloat16()).add(p.bias.bfloat16()).reshape(
                    b, t, attn.num_heads, attn.head_dim) for p in (attn.query, attn.key, attn.value))
                got, _ = fa.flash_attention_fwd(q, k, v)
                want, _ = fa.flash_attention_bf16_plain(q, k, v)
                cpu, _ = fa.flash_attention_bf16_plain(q.cpu(), k.cpu(), v.cpu())
            else:
                kernel, plain = {
                    "mnist": (ff.fused_mnist_probs_bf16, ff.fused_mnist_probs_bf16_plain),
                    "cifar10": (ff.fused_cifar10_probs_bf16, ff.fused_cifar10_probs_bf16_plain),
                }[family]
                fused = {name: t.to(dev) for name, t in params["fused"].items()}
                x = torch.from_numpy(x_tr[:10_000])
                got, want = kernel(fused, x.to(dev)), plain(fused, x.to(dev))
                cpu = plain(params["fused"], x)
        print(json.dumps({"family": family, "kernel_vs_plain": stats(got, want),
                          "plain_card_vs_cpu": stats(want, cpu),
                          "kernel_vs_cpu_plain": stats(got, cpu)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
