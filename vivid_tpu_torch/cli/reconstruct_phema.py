"""Post-hoc EMA reconstruction CLI: snapshots at any EMA std from a
training run's two tracked per-std snapshot series (EDM2 Algorithm 3).

    python -m vivid_tpu_torch.cli.reconstruct_phema \\
        --in-dir=runs/experiments --out-dir=out \\
        --out-std=0.075,0.130 [--out-nimg=2048000]

The options are the JAX package's (vivid_tpu/cli/reconstruct_phema.py);
the snapshots read and written are in the format both packages share.
"""

import click

from vivid_tpu_torch.diffusion.phema import list_phema_snapshots, reconstruct_phema


@click.command()
@click.option("--in-dir", "in_dir", required=True, metavar="DIR",
              help="Training run directory holding network-snapshot-*-*.pkl")
@click.option("--out-dir", "out_dir", required=True, metavar="DIR",
              help="Where to write phema-*-*.pkl reconstructions")
@click.option("--out-std", "out_std", required=True, metavar="LIST",
              help="Comma-separated target EMA stds, e.g. 0.075,0.130")
@click.option("--out-nimg", "out_nimg", type=int, default=None,
              help="Reconstruction point in images [default: latest snapshot]")
def main(in_dir, out_dir, out_std, out_nimg):
    stds = [float(s) for s in str(out_std).split(",") if s]
    snaps = list_phema_snapshots(in_dir)
    if not snaps:
        raise click.ClickException(f"no snapshot series in {in_dir!r}")
    click.echo(f"Reconstructing {len(stds)} std(s) from {len(snaps)} snapshots")
    results = reconstruct_phema(in_dir, stds, out_nimg=out_nimg, out_dir=out_dir)
    for r in results:
        click.echo(f"std={r.std:.3f} nimg={r.nimg} -> {r.path}")
    return results


if __name__ == "__main__":
    main()
