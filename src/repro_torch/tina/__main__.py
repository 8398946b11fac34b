from repro_torch.tina import main

if __name__ == "__main__":
    raise SystemExit(main())
