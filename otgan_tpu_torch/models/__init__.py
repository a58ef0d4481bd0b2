from otgan_tpu_torch.models import dcgan, densenet, toy_mlp


def get_model(name: str):
    """Model-family switch of the reference's ``--model`` flag. Returns the
    module exposing ``make_generator``, ``make_discriminator`` and
    ``sample_latent``."""
    if name == "dcgan":
        return dcgan
    if name == "densenet":
        return densenet
    if name == "toy_mlp":
        return toy_mlp
    raise ValueError(f"unknown model {name!r}; choose dcgan|densenet|toy_mlp")
