"""The whole step's share of the card's bf16 peak, in %: the frozen count
of matmul FLOPs an image (yardstick.train_flops_per_image, cached or not
as the mix says) times the window's train_img_per_s."""

from gpubench import yardstick


def read(ctx):
    t = ctx["traffic"]
    f = yardstick.train_flops_per_image(ctx["config"], t["trainable_last_k"], t["cached"])
    return 100.0 * f * ctx["e2e"]["train_img_per_s"] / ctx["peak_flops"]
