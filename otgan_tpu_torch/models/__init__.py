from otgan_tpu_torch.models import dcgan

_LATER = {
    "densenet": "the model-zoo slice (ROADMAP queue 1)",
    "toy_mlp": "the toy-model slice (ROADMAP queue 1)",
}


def get_model(name: str):
    """Model-family switch of the reference's ``--model`` flag. The port
    knows ``dcgan``; the other families come in later slices."""
    if name == "dcgan":
        return dcgan
    if name in _LATER:
        raise NotImplementedError(
            f"--model {name} is not ported yet; it comes with {_LATER[name]}"
        )
    raise ValueError(f"unknown model {name!r}; choose dcgan|densenet|toy_mlp")
