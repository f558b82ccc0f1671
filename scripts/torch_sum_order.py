#!/usr/bin/env python3
"""How often torch.sum on the card adds a row in column order.

    python3 scripts/torch_sum_order.py     (one CUDA GPU)

Kernel 2 of the PyTorch port (dartenv_tpu_torch/csrc/bpp.cu) sums each
matvec row over the columns in order; its plain version
(lcp/hopper_bpp.bpp_solve_reference) calls torch.sum.  For random (K, m, m)
operators and (K, m) vectors at walker2d's (m = 24) and humanwalker's
(m = 41) escalation sizes, this prints how many entries of
torch.sum(A * x[:, None, :], -1), and of one row torch.sum(A[:, 3] * x, -1),
equal a column-order sum to the bit, beside the card's name and power
limit."""
import subprocess

import torch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_sum_order: needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, m in (("walker2d", 24), ("humanwalker", 41)):
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        K = 128
        A = torch.rand((K, m, m), generator=g, device=dev) - 0.5
        x = torch.rand((K, m), generator=g, device=dev) - 0.5
        ref = torch.sum(A * x[:, None, :], dim=-1)
        seq = torch.zeros((K, m), device=dev)
        for j in range(m):
            seq = seq + A[:, :, j] * x[:, None, j]
        row = torch.sum(A[:, 3, :] * x, dim=-1)
        print(f"{name} m={m}: matvec equal to the column-order sum on "
              f"{int((ref == seq).sum())} of {K * m} entries, one row on "
              f"{int((row == seq[:, 3]).sum())} of {K}")


if __name__ == "__main__":
    main()
