"""Model zoo: TCN (Lemaire), CNNs (Doukhan, Papakostas, Jang),
shared-trunk MTL heads, cascaded MTL, intermediate fusion."""

from .zoo import MODEL_NAMES, ModelSpec, get_model  # noqa: F401
