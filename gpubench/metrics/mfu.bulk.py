"""The whole forward's share of the card's bf16 peak, in %: the frozen
count of matmul FLOPs an image (yardstick.serve_flops_per_image) times the
window's bulk_img_per_s."""

from gpubench import yardstick


def read(ctx):
    return 100.0 * yardstick.serve_flops_per_image(ctx["config"]) \
        * ctx["e2e"]["bulk_img_per_s"] / ctx["peak_flops"]
