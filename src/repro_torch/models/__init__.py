"""Model zoo: dense all-GQA decoders (port of ``repro.models``)."""
