#!/usr/bin/env python3
"""Cluster submission helper: generate (and optionally submit) a batch
script that launches smarties_tpu training on a SLURM cluster.

Reference analog: bin/smarties.py's Euler / Piz Daint SLURM presets
(bin/smarties.py:30-43 and the sbatch templates further down). The
reference submits MPI rank grids; here each HOST runs one python process
and multi-host coordination happens through `jax.distributed`
(smarties_tpu.parallel.mesh.init_distributed), so the batch script sets
the coordinator address/rank env vars and runs the same launcher CLI on
every node.

Presets:
  --preset slurm      generic SLURM cluster (one task per host)

The generated script is written to <runprefix>/<runname>/submit.sh and
printed; pass --submit to exec sbatch immediately.
"""
import argparse
import os
import shlex
import subprocess
import sys

SLURM_TEMPLATE = """#!/bin/bash -l
#SBATCH --job-name={runname}
#SBATCH --output={run_dir}/out.%j.log
#SBATCH --error={run_dir}/err.%j.log
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={time}
{partition_line}{account_line}
# one python process per host; jax.distributed wires the mesh
export SMARTIES_TPU_COORD_ADDR=$(scontrol show hostnames \
  "$SLURM_JOB_NODELIST" | head -n1):{port}
export SMARTIES_TPU_NUM_PROCS=$SLURM_NNODES

srun --kill-on-bad-exit=1 bash -c '
  export SMARTIES_TPU_PROC_ID=$SLURM_PROCID
  exec python {launcher} {app} {launch_args}
'
"""

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("app", help="built-in env name or app script path")
    ap.add_argument("--preset", default="slurm",
                    choices=["slurm"])
    ap.add_argument("--runname", default="run00")
    ap.add_argument("--runprefix", default="runs")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--cpus", type=int, default=16)
    ap.add_argument("--time", default="24:00:00")
    ap.add_argument("--partition", default=None)
    ap.add_argument("--account", default=None)
    ap.add_argument("--port", type=int, default=12346)
    ap.add_argument("--submit", action="store_true",
                    help="sbatch the generated script")
    args, passthrough = ap.parse_known_args()

    run_dir = os.path.join(args.runprefix, args.runname)
    os.makedirs(run_dir, exist_ok=True)
    launcher = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "smarties_tpu_launch.py")
    launch_args = " ".join(
        shlex.quote(a) for a in
        ["--runname", args.runname, "--runprefix", args.runprefix]
        + passthrough)

    script = SLURM_TEMPLATE.format(
        runname=args.runname, run_dir=run_dir, nodes=args.nodes,
        cpus=args.cpus, time=args.time,
        partition_line=(f"#SBATCH --partition={args.partition}\n"
                        if args.partition else ""),
        account_line=(f"#SBATCH --account={args.account}\n"
                      if args.account else ""),
        port=args.port, launcher=launcher,
        app=shlex.quote(args.app), launch_args=launch_args)

    path = os.path.join(run_dir, "submit.sh")
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, 0o755)
    print(script)
    print(f"# written to {path}", file=sys.stderr)
    if args.submit:
        subprocess.run(["sbatch", path], check=True)


if __name__ == "__main__":
    main()
