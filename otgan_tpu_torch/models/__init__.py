from otgan_tpu_torch.models import dcgan, toy_mlp

_LATER = {"densenet": "the model-zoo slice (ROADMAP queue 1)"}


def get_model(name: str):
    """Model-family switch of the reference's ``--model`` flag. Returns the
    module exposing ``make_generator``, ``make_discriminator`` and
    ``sample_latent``. The port knows ``dcgan`` and ``toy_mlp``; densenet
    comes in a later slice."""
    if name == "dcgan":
        return dcgan
    if name == "toy_mlp":
        return toy_mlp
    if name in _LATER:
        raise NotImplementedError(
            f"--model {name} is not ported yet; it comes with {_LATER[name]}"
        )
    raise ValueError(f"unknown model {name!r}; choose dcgan|densenet|toy_mlp")
